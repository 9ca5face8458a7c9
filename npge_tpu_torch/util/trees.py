# mirrors npge_tpu/util/trees.py
"""Phylogenetic tree utilities: NJ, UPGMA, Newick, consensus splits.

Equivalent of the reference's generic tree code (``src/util/tree.hpp``
⚠[B], SURVEY.md §2.4) used by PrintTree / ConsensusTree / FragmentDistance.
All algorithms use deterministic tie-breaking (smallest index pair wins) so
reruns produce identical trees.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class TreeNode:
    name: str | None = None          # leaf name (None for internal)
    children: list = field(default_factory=list)  # [(child, branch_len)]
    support: float | None = None

    def is_leaf(self) -> bool:
        return not self.children

    def leaves(self) -> list[str]:
        if self.is_leaf():
            return [self.name]
        out = []
        for c, _ in self.children:
            out.extend(c.leaves())
        return out

    def newick(self, with_support: bool = False) -> str:
        return self._nwk(with_support) + ";"

    def _nwk(self, ws: bool) -> str:
        if self.is_leaf():
            return self.name or ""
        parts = []
        for c, bl in self.children:
            s = c._nwk(ws)
            if bl is not None:
                s += f":{bl:.6g}"
            parts.append(s)
        label = ""
        if ws and self.support is not None:
            label = f"{self.support:.2f}"
        return f"({','.join(parts)}){label}"


def upgma(dist: np.ndarray, names: list[str]) -> TreeNode:
    """UPGMA clustering; deterministic (smallest (i,j) on ties)."""
    n = len(names)
    d = dist.astype(float).copy()
    nodes = [TreeNode(name=nm) for nm in names]
    heights = [0.0] * n
    sizes = [1] * n
    active = list(range(n))
    while len(active) > 1:
        best = None
        for ai in range(len(active)):
            for aj in range(ai + 1, len(active)):
                i, j = active[ai], active[aj]
                key = (d[i, j], i, j)
                if best is None or key < best[0]:
                    best = (key, i, j)
        _, i, j = best
        h = d[i, j] / 2.0
        parent = TreeNode(
            children=[
                (nodes[i], h - heights[i]),
                (nodes[j], h - heights[j]),
            ]
        )
        # merge j into i
        new_row = (d[i] * sizes[i] + d[j] * sizes[j]) / (sizes[i] + sizes[j])
        d[i, :] = new_row
        d[:, i] = new_row
        d[i, i] = 0.0
        nodes[i] = parent
        heights[i] = h
        sizes[i] += sizes[j]
        active.remove(j)
    return nodes[active[0]]


def neighbor_joining(dist: np.ndarray, names: list[str]) -> TreeNode:
    """Classic NJ; deterministic (smallest (i,j) on Q-ties)."""
    n = len(names)
    if n == 1:
        return TreeNode(name=names[0])
    if n == 2:
        return TreeNode(
            children=[
                (TreeNode(name=names[0]), dist[0, 1] / 2),
                (TreeNode(name=names[1]), dist[0, 1] / 2),
            ]
        )
    d = dist.astype(float).copy()
    nodes = [TreeNode(name=nm) for nm in names]
    active = list(range(n))
    while len(active) > 2:
        m = len(active)
        r = {i: sum(d[i, k] for k in active if k != i) for i in active}
        best = None
        for ai in range(m):
            for aj in range(ai + 1, m):
                i, j = active[ai], active[aj]
                q = (m - 2) * d[i, j] - r[i] - r[j]
                key = (q, i, j)
                if best is None or key < best[0]:
                    best = (key, i, j)
        _, i, j = best
        li = d[i, j] / 2 + (r[i] - r[j]) / (2 * (m - 2))
        lj = d[i, j] - li
        parent = TreeNode(children=[(nodes[i], max(li, 0.0)), (nodes[j], max(lj, 0.0))])
        for k in active:
            if k in (i, j):
                continue
            nd = (d[i, k] + d[j, k] - d[i, j]) / 2
            d[i, k] = d[k, i] = nd
        nodes[i] = parent
        active.remove(j)
    i, j = active
    return TreeNode(
        children=[(nodes[i], d[i, j] / 2), (nodes[j], d[i, j] / 2)]
    )


def splits_of(tree: TreeNode, all_leaves: frozenset[str]) -> set[frozenset[str]]:
    """Non-trivial bipartitions induced by internal edges (as the smaller
    side / canonical frozenset of leaf names)."""
    out: set[frozenset[str]] = set()

    def rec(node: TreeNode) -> frozenset[str]:
        if node.is_leaf():
            return frozenset([node.name])
        below = frozenset().union(*(rec(c) for c, _ in node.children))
        if 1 < len(below) < len(all_leaves) - 1:
            side = below
            other = all_leaves - below
            out.add(min(side, other, key=lambda s: (len(s), sorted(s))))
        return below

    rec(tree)
    return out


def _compatible(s: frozenset, chosen: list[frozenset], leaves: frozenset) -> bool:
    for t in chosen:
        # two splits are compatible iff one of the four intersections is empty
        if not (
            not (s & t)
            or not (s - t)
            or not (t - s)
            or not (leaves - s - t)
        ):
            return False
    return True


def majority_consensus(
    trees: list[TreeNode], names: list[str]
) -> TreeNode:
    """Greedy (majority-rule extended) consensus tree with branch support =
    fraction of input trees containing the split. Deterministic order:
    support desc, then canonical split."""
    leaves = frozenset(names)
    counts: dict[frozenset, int] = {}
    for t in trees:
        for s in splits_of(t, leaves):
            counts[s] = counts.get(s, 0) + 1
    order = sorted(
        counts.items(), key=lambda kv: (-kv[1], sorted(kv[0]))
    )
    chosen: list[frozenset] = []
    support: dict[frozenset, float] = {}
    for s, c in order:
        if _compatible(s, chosen, leaves):
            chosen.append(s)
            support[s] = c / max(len(trees), 1)
    # build tree: nest splits by containment
    chosen.sort(key=len)
    root = TreeNode(children=[(TreeNode(name=nm), None) for nm in sorted(names)])

    def find_parent(node: TreeNode, s: frozenset) -> TreeNode:
        for c, _ in node.children:
            if not c.is_leaf():
                below = frozenset(c.leaves())
                if s <= below:
                    return find_parent(c, s)
        return node

    for s in sorted(chosen, key=lambda x: -len(x)):
        parent = find_parent(root, s)
        inside = [
            (c, bl)
            for c, bl in parent.children
            if frozenset(c.leaves()) <= s
        ]
        if len(inside) < 2:
            continue
        rest = [cb for cb in parent.children if cb not in inside]
        new = TreeNode(children=inside, support=support[s])
        parent.children = rest + [(new, None)]
    return root

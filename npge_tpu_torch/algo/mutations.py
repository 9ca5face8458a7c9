# mirrors npge_tpu/algo/mutations.py
"""PrintMutations — per-block substitution/indel calls vs consensus.

Equivalent of the reference's mutations processor (``src/algo/
PrintMutations.cpp`` ⚠[B], SURVEY.md §2.3): for every fragment of every
multi-fragment block, emit one row per column where the fragment differs
from the block consensus (substitution, deletion '-' in the fragment, or
insertion relative to a consensus gap column).
"""

from __future__ import annotations

import numpy as np

from npge_tpu_torch.model.blocks import BlockSet, column_consensus
from npge_tpu_torch.io.bs import fragment_id
from npge_tpu_torch.util import codes as C

# the single consensus semantics lives in model.blocks.column_consensus
# (VERDICT r2 weak #7: mutations must agree with the ConSeq consensus)
_column_consensus = column_consensus


def mutations_tsv(bs: BlockSet) -> str:
    """TSV: block, fragment, column, consensus_char, fragment_char."""
    out = ["block\tfragment\tcolumn\tconsensus\tchar"]
    for b in bs.blocks:
        if b.n_frags < 2:
            continue
        rows = b.rows(bs.arena)
        cons = _column_consensus(rows)
        diff = rows != cons[None, :]
        for fi in range(b.n_frags):
            fid = fragment_id(bs.arena, *b.frags.row(fi))
            for col in np.flatnonzero(diff[fi]):
                out.append(
                    "\t".join(
                        [
                            b.name or "?",
                            fid,
                            str(int(col)),
                            C.decode(cons[col : col + 1]),
                            C.decode(rows[fi, col : col + 1]),
                        ]
                    )
                )
    return "\n".join(out) + "\n"

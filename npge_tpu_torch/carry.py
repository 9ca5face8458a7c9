"""Hand a world built elsewhere to the port as numpy arrays and text.

The port shares no object with the JAX package: an arena crosses as its
sequence names and code arrays, a blockset as ``.bs`` text (the format both
packages write), and a config as a dict (``Config.from_dict``). These
functions take only such values and return the port's own objects.
"""

from __future__ import annotations

import io

import numpy as np

from npge_tpu_torch.io.bs import read_blockset
from npge_tpu_torch.model.arena import GenomeArena
from npge_tpu_torch.model.blocks import BlockSet


def arena_from_arrays(names, seqs) -> GenomeArena:
    """The port's arena of sequences ``names`` with uint8 code arrays
    ``seqs`` (0..4, one array per sequence)."""
    return GenomeArena(
        [str(n) for n in names], [np.asarray(s, dtype=np.uint8) for s in seqs]
    )


def blockset_from_bs_text(arena: GenomeArena, text: str) -> BlockSet:
    """The port's blockset over ``arena`` read from ``.bs`` text."""
    return read_blockset(io.StringIO(text), arena)

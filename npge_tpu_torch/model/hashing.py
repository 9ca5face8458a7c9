# mirrors npge_tpu/model/hashing.py
"""Order-independent block / blockset hashing.

Equivalent of the reference's ``block_hash`` / ``blockset_hash``
(``src/model/block_hash.hpp`` ⚠[B], SURVEY.md §2.1): cheap equality checks
between runs and the revert-if-worse test of TrySmth. Hash identity across
1-chip / 1-host / N-host runs is the distributed-correctness bar (SURVEY §4).

Hashes depend only on fragment coordinates + sequence names + alignment
content, never on in-memory order.
"""

from __future__ import annotations

import hashlib

from npge_tpu_torch.model.blocks import Block, BlockSet


def _h64(data: bytes) -> int:
    return int.from_bytes(hashlib.sha1(data).digest()[:8], "little")


def fragment_key(arena, seq_id: int, start: int, length: int, ori: int) -> str:
    return f"{arena.names[seq_id]}:{start}:{length}:{ori}"


def block_hash(block: Block, arena) -> int:
    parts = []
    for i in range(block.n_frags):
        s, st, ln, o = block.frags.row(i)
        parts.append(fragment_key(arena, s, st, ln, o))
    parts.sort()
    payload = "|".join(parts).encode()
    if block.alignment is not None:
        # alignment rows in the same sorted-fragment order
        order = sorted(
            range(block.n_frags),
            key=lambda i: fragment_key(arena, *block.frags.row(i)),
        )
        payload += b"#" + block.alignment[order].tobytes()
    return _h64(payload)


def blockset_hash(bs: BlockSet, memo: dict | None = None) -> int:
    """Order-independent: hash of the sorted block hashes.

    (Not an XOR fold: XOR cancels duplicate blocks — {A, A, B} would collide
    with {B} plus any self-cancelling pair, and pre-Rest candidate sets can
    legitimately contain duplicates.)

    ``memo`` (id -> (block, hash)) carries per-block hashes across calls:
    blocks are immutable and block names never enter the hash, so the
    reseed loop's per-round full-blockset hash only pays for blocks that
    actually changed. Entries pin their block object (id-alias safety)."""
    if memo is None:
        hs = sorted(block_hash(b, bs.arena) for b in bs.blocks)
    else:
        hs = []
        for b in bs.blocks:
            hit = memo.get(id(b))
            if hit is None:
                hit = (b, block_hash(b, bs.arena))
                memo[id(b)] = hit
            hs.append(hit[1])
        hs.sort()
    payload = b"%d;" % len(hs) + b"".join(h.to_bytes(8, "little") for h in hs)
    return _h64(payload)

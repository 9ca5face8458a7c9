"""Worker for the port's two-process tests: one gloo process of a
``torch.distributed`` group each, with jax and the JAX package blocked.

Usage: python torch_mp_worker.py <rank> <world_size> <init_method> <out>
       [anchors|pipeline]

<init_method> "env" starts the group with ``init_distributed()`` from the
launcher variables in the environment.

"anchors" (default): the multi-process anchor scan of ``world()``; writes
"<groups> <occurrences> <sha256 of offsets, pos, seq_id, strand>".

"pipeline": the whole ``build_pangenome`` split across the processes;
writes "<blocks> <canonical blockset hash>", and this rank's ``mp.*`` and
``gapext_pairs`` counters to ``<out>.counters<rank>``.

``world()`` and the config are those of ``tests/mp_worker.py``, built with
the port's copy of ``synthetic_arena``.
"""

import hashlib
import importlib.abc
import os
import sys


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "npge_tpu"):
            raise ImportError(f"blocked {name}")
        return None


def world():
    from npge_tpu_torch.util.synthetic import synthetic_arena

    return synthetic_arena(
        n_genomes=3, length=20_000, seed=31, sub_rate=0.004,
        indel_rate=0.0005, n_inversions=1,
    )


def main():
    rank, size, init, out = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    )
    mode = sys.argv[5] if len(sys.argv) > 5 else "anchors"
    sys.meta_path.insert(0, _Block())
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch.distributed as dist

    from npge_tpu_torch.config import default_config

    if init == "env":  # a launcher's RANK / WORLD_SIZE / MASTER_ADDR
        from npge_tpu_torch.parallel.distributed import init_distributed

        assert init_distributed() == (rank, size)
    else:
        dist.init_process_group(
            "gloo", init_method=init, world_size=size, rank=rank
        )
    try:
        arena = world()
        cfg = default_config().replace(ANCHOR_SIZE=17, MINIMIZER_WINDOW=6)
        if mode == "pipeline":
            from npge_tpu_torch.algo.pangenome import build_pangenome
            from npge_tpu_torch.model.hashing import blockset_hash

            bs, tm = build_pangenome(arena, cfg, "cpu")
            bs.canonicalize()
            line = f"{len(bs.blocks)} {blockset_hash(bs)}"
            with open(out + f".counters{rank}", "w") as fh:
                for k in sorted(tm.counters):
                    if k.startswith("mp.") or k == "gapext_pairs":
                        fh.write(f"{k} {tm.counters[k]}\n")
        else:
            from npge_tpu_torch.parallel.distributed import (
                multihost_find_anchors,
            )

            groups = multihost_find_anchors(arena, cfg, "cpu")
            d = hashlib.sha256()
            for a in (groups.offsets, groups.pos, groups.seq_id, groups.strand):
                d.update(a.tobytes())
            line = f"{groups.n_groups} {len(groups.pos)} {d.hexdigest()}"
    finally:
        dist.destroy_process_group()
    for mod in ("jax", "jaxlib", "npge_tpu"):
        assert mod not in sys.modules, mod
    with open(out, "w") as fh:
        fh.write(line + "\n")


if __name__ == "__main__":
    main()

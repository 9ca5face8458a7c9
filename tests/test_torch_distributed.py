"""Two real gloo processes of the port (``tests/torch_mp_worker.py``, jax
and the JAX package blocked in each) against the reference's
single-process results on the same world: the multi-process anchor scan
and the whole multi-process build, with each rank owning a real share of
the split work."""

import hashlib
import os
import socket
import subprocess
import sys

import pytest

from mp_worker import world as ref_world
from npge_tpu.algo.pangenome import build_pangenome as ref_build
from npge_tpu.config import default_config
from npge_tpu.model.hashing import blockset_hash
from npge_tpu.parallel.distributed import multihost_find_anchors

HERE = os.path.dirname(os.path.abspath(__file__))


def ref_cfg():
    return default_config().replace(ANCHOR_SIZE=17, MINIMIZER_WINDOW=6)


def run_ranks(tmp_path, mode: str, size: int = 2, launcher: bool = False):
    """Start ``size`` workers in one gloo group and return each rank's
    output line. The group starts from a file:// init in ``tmp_path``, or
    with ``launcher`` from torchrun's variables through
    ``init_distributed``."""
    init = "env" if launcher else f"file://{tmp_path / 'gloo_init'}"
    outs = [str(tmp_path / f"{mode}{r}.txt") for r in range(size)]
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
    }
    if launcher:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            env.update(MASTER_ADDR="localhost", MASTER_PORT=str(s.getsockname()[1]),
                       WORLD_SIZE=str(size))
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_mp_worker.py"),
             str(r), str(size), init, outs[r], mode],
            env={**env, "RANK": str(r)} if launcher else env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for r in range(size)
    ]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [open(o).read().strip() for o in outs]


@pytest.mark.parametrize("size", [2, 3])
def test_multi_process_anchors_equal_reference(tmp_path, size):
    """Every rank holds the reference's groups; three ranks split the
    arena unevenly and start from a launcher's variables."""
    lines = run_ranks(tmp_path, "anchors", size, launcher=size == 3)
    assert len(set(lines)) == 1, lines
    groups = multihost_find_anchors(ref_world(), ref_cfg())
    d = hashlib.sha256()
    for a in (groups.offsets, groups.pos, groups.seq_id, groups.strand):
        d.update(a.tobytes())
    assert lines[0] == f"{groups.n_groups} {len(groups.pos)} {d.hexdigest()}"


def test_two_process_build_equals_reference(tmp_path):
    lines = run_ranks(tmp_path, "pipeline")
    assert lines[0] == lines[1], lines
    bs, _ = ref_build(ref_world(), ref_cfg())
    bs.canonicalize()
    assert lines[0] == f"{len(bs.blocks)} {blockset_hash(bs)}"

    def counters(r):
        path = tmp_path / f"pipeline{r}.txt.counters{r}"
        return {k: int(v) for k, v in (ln.split() for ln in open(path))}

    c = [counters(r) for r in range(2)]
    for owned, total in (
        ("mp.extend_groups_owned", "mp.extend_groups_total"),
        ("mp.reseed.extend_groups_owned", "mp.reseed.extend_groups_total"),
        ("mp.gapext_pairs_owned", "gapext_pairs"),
    ):
        assert c[0][total] == c[1][total], (total, c)
        assert c[0][owned] + c[1][owned] == c[0][total], (owned, c)
        for r in range(2):
            assert 0 < c[r][owned] < c[r][total], (owned, r, c)


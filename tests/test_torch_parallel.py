"""npge_tpu_torch.parallel on the CPU against the JAX reference: host
slices, the position-sliced scan, the sharded anchor scan, the extension
split over a mesh, mesh builds and ``make-pangenome --devices``. The
reference's meshes are the 8 virtual CPU devices of ``tests/conftest.py``;
the port's are written out as n shards on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from npge_tpu.algo.anchors import find_anchors as ref_find_anchors
from npge_tpu.algo.extender import extend_anchor_groups as ref_extend
from npge_tpu.algo.pangenome import build_pangenome as ref_build
from npge_tpu.cli import main as ref_main
from npge_tpu.config import default_config
from npge_tpu.io.checkpoint import load_stage, save_stage
from npge_tpu.model.blocks import BlockSet
from npge_tpu.model.hashing import blockset_hash
from npge_tpu.parallel import distributed as ref_dist
from npge_tpu.parallel.mesh import make_mesh as ref_make_mesh
from npge_tpu.parallel.sharded import sharded_find_anchors as ref_sharded
from npge_tpu.util.synthetic import synthetic_arena
from npge_tpu_torch.algo.anchors import find_anchors
from npge_tpu_torch.algo.extender import extend_anchor_groups
from npge_tpu_torch.algo.is_pangenome import check_is_pangenome
from npge_tpu_torch.algo.pangenome import StageTimings, build_pangenome
from npge_tpu_torch.cli import main
from npge_tpu_torch.model.hashing import blockset_hash as port_hash
from npge_tpu_torch.ops.kmers import find_anchor_occurrences
from npge_tpu_torch.parallel import distributed
from npge_tpu_torch.parallel.mesh import DeviceMesh, make_mesh
from npge_tpu_torch.parallel.sharded import sharded_find_anchors
from torch_carry import port_arena, port_config

# the 5 x 20 kb circular world's hash (MULTICHIP_r05: 8 devices, equal to
# the single-device build)
MULTICHIP_HASH = 14129187163991902977
GROUP_FIELDS = ("offsets", "pos", "seq_id", "strand")
BATCH_FIELDS = ("offsets", "seq", "start", "length", "ori")


def cpu_mesh(n: int) -> DeviceMesh:
    return DeviceMesh(["cpu"] * n)


def ref_key(h, l):
    """The port's int64 key of the reference's (hi, lo) uint32 pair (k <= 31)."""
    return (h.astype(np.int64) << 32) | l.astype(np.int64)


def scan_world():
    arena = synthetic_arena(n_genomes=2, length=6000, seed=31, indel_rate=0.0)
    return arena, default_config().replace(ANCHOR_SIZE=17, MINIMIZER_WINDOW=8)


SHARD_WORLDS = {
    "linear": lambda: synthetic_arena(
        n_genomes=2, length=4000, seed=21, indel_rate=0.0
    ),
    "circular": lambda: synthetic_arena(
        n_genomes=3, length=3000, seed=5, sub_rate=0.01, n_inversions=1,
        circular=True,
    ),
}


def test_host_slice_partition():
    for total in (0, 1, 7, 103, 1000):
        for pc in (1, 2, 3, 4, 5, 8):
            parts = [distributed.host_slice(total, i, pc) for i in range(pc)]
            assert parts == [ref_dist.host_slice(total, i, pc) for i in range(pc)]
            assert parts[0][0] == 0 and parts[-1][1] == total
            assert all(b == c for (_a, b), (c, _d) in zip(parts, parts[1:]))
    mesh = cpu_mesh(4)
    assert [(lo, hi) for _d, lo, hi in mesh.slices(103)] == [
        ref_dist.host_slice(103, i, 4) for i in range(4)
    ]


@pytest.mark.parametrize("pc", [2, 5])
def test_scan_slices_unite_to_single_device(pc):
    arena, cfg = scan_world()
    pa, pcfg, k = port_arena(arena), port_config(cfg), cfg.ANCHOR_SIZE
    keys, poss, strands = [], [], []
    for pi in range(pc):
        lo, hi = distributed.host_slice(arena.total_length, pi, pc)
        key, pos, strand = distributed.scan_slice(pa, pcfg, k, lo, hi, "cpu")
        h, l, rpos, rstrand = ref_dist.scan_slice(arena, cfg, k, lo, hi)
        np.testing.assert_array_equal(key, ref_key(h, l))
        np.testing.assert_array_equal(pos, rpos)
        np.testing.assert_array_equal(strand, rstrand)
        keys.append(key)
        poss.append(pos)
        strands.append(strand)
    key, pos, strand = (np.concatenate(x) for x in (keys, poss, strands))
    order = np.lexsort((pos, key))
    single = find_anchor_occurrences(
        pa.codes, None, k, cfg.MINIMIZER_WINDOW, "cpu", offsets=pa.offsets
    )
    for got, want in zip((key[order], pos[order], strand[order]), single):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", sorted(SHARD_WORLDS))
@pytest.mark.parametrize("n", [2, 3, 8])
def test_sharded_find_anchors_matches_reference_mesh(world, n):
    arena = SHARD_WORLDS[world]()
    cfg = default_config().replace(ANCHOR_SIZE=17, MINIMIZER_WINDOW=8)
    want = ref_sharded(arena, cfg, ref_make_mesh(n))
    got = sharded_find_anchors(port_arena(arena), port_config(cfg), cpu_mesh(n))
    assert got.n_groups > 10
    for f in GROUP_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    single = find_anchors(port_arena(arena), port_config(cfg), "cpu")
    # the reference's mesh path scans a circular arena linearly, unlike
    # find_anchors' cyclic scan: mirrored, not fixed
    same = all(
        np.array_equal(getattr(got, f), getattr(single, f)) for f in GROUP_FIELDS
    )
    assert same == (world == "linear")


@pytest.mark.parametrize("world", sorted(SHARD_WORLDS))
def test_multihost_find_anchors_single_process(world):
    arena = SHARD_WORLDS[world]()
    cfg = default_config().replace(ANCHOR_SIZE=17, MINIMIZER_WINDOW=8)
    assert distributed.process_index_count() == (0, 1)
    assert not distributed.multiprocess()
    assert distributed.init_distributed() == (0, 1)  # no launcher env: no group
    got = distributed.multihost_find_anchors(
        port_arena(arena), port_config(cfg), "cpu"
    )
    want = ref_dist.multihost_find_anchors(arena, cfg)
    for f in GROUP_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("n", [2, 3, 8])
def test_extension_split_over_mesh(n):
    arena = synthetic_arena(n_genomes=3, length=6000, seed=3, indel_rate=0.0)
    cfg = default_config().replace(ANCHOR_SIZE=17, MINIMIZER_WINDOW=8)
    pa, pcfg = port_arena(arena), port_config(cfg)
    groups = find_anchors(pa, pcfg, "cpu")
    t1, t2 = StageTimings(), StageTimings()
    single = extend_anchor_groups(pa, groups, pcfg, "cpu", timings=t1)
    meshed = extend_anchor_groups(
        pa, groups, pcfg, "cpu", timings=t2, mesh=cpu_mesh(n)
    )
    assert t2.counters == t1.counters and t1.counters["extend_cells"] > 0
    want = ref_extend(
        arena, ref_find_anchors(arena, cfg), cfg, mesh=ref_make_mesh(n)
    )
    assert len(meshed) == len(want) > 10
    for f in BATCH_FIELDS:
        np.testing.assert_array_equal(getattr(meshed, f), getattr(single, f))
        np.testing.assert_array_equal(getattr(meshed, f), getattr(want, f))


@pytest.fixture(scope="module")
def circular_world():
    arena = synthetic_arena(
        n_genomes=5, length=20_000, seed=11, sub_rate=0.004,
        indel_rate=0.0008, n_inversions=2, circular=True,
    )
    cfg = default_config().replace(
        ANCHOR_SIZE=17, MINIMIZER_WINDOW=8, MIN_LENGTH=60, MIN_END=3,
        MAX_LOOPS=2, GAPPED_FLANK=64,
    )
    return arena, cfg


@pytest.mark.parametrize("n", [2, 3, 8])
def test_mesh_build_matches_reference_mesh(circular_world, n):
    arena, cfg = circular_world
    ref, _ = ref_build(arena, cfg, mesh=ref_make_mesh(n))
    got, tm = build_pangenome(
        port_arena(arena), port_config(cfg), "cpu", mesh=cpu_mesh(n)
    )
    assert tm.counters["gapext_pairs"] > 0
    assert check_is_pangenome(got, port_config(cfg)).ok
    assert port_hash(got) == blockset_hash(ref) == MULTICHIP_HASH


def test_mesh_build_linear_world_matches_single_device():
    arena = synthetic_arena(
        n_genomes=3, length=5000, seed=13, sub_rate=0.01, indel_rate=0.0005
    )
    cfg = default_config().replace(
        ANCHOR_SIZE=17, MINIMIZER_WINDOW=8, MIN_LENGTH=60, MIN_END=3,
        MAX_LOOPS=3,
    )
    ref, _ = ref_build(arena, cfg)
    pa, pcfg = port_arena(arena), port_config(cfg)
    single, t1 = build_pangenome(pa, pcfg, "cpu")
    meshed, t2 = build_pangenome(pa, pcfg, "cpu", mesh=cpu_mesh(3))
    assert port_hash(meshed) == port_hash(single) == blockset_hash(ref)
    # a linear world scans the same anchors either way, so every counter
    # (extension cells included) agrees
    assert t2.counters == t1.counters


def test_mesh_is_explicit():
    assert repr(cpu_mesh(3)) == "3 shards on 1 device(s): cpu"
    assert make_mesh(1, "cpu").devices == [torch.device("cpu")]
    with pytest.raises(ValueError):
        make_mesh(2, "cpu")  # torch sees one CPU device
    with pytest.raises(ValueError):
        make_mesh(0, "cpu")
    with pytest.raises(ValueError):
        DeviceMesh([])
    arena = synthetic_arena(n_genomes=2, length=2000, seed=2)
    with pytest.raises(ValueError):  # the mesh must start at the device
        build_pangenome(
            port_arena(arena), port_config(default_config()), "cpu",
            mesh=_FakeMesh(),
        )


class _FakeMesh:
    """A mesh whose first device is not the CPU (no second device exists
    on this machine to build a real one)."""

    devices = [torch.device("meta")]


OPTS = ["-o", "ANCHOR_SIZE=17", "-o", "MIN_LENGTH=60", "-o", "MIN_END=3",
        "-o", "GAPPED_FLANK=64"]


def test_cli_devices_cpu_matches_reference(tmp_path):
    arena = synthetic_arena(
        n_genomes=3, length=6000, seed=12, sub_rate=0.006, indel_rate=0.001
    )
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    for d in (ref_dir, port_dir):
        save_stage(d, "input", BlockSet(arena, []))
    ref_main(["make-pangenome", "-w", ref_dir, "--platform", "cpu",
              "--devices", "4", *OPTS])
    main(["make-pangenome", "-w", port_dir, "--device", "cpu",
          "--devices", "4", *OPTS])
    for name in ("input.bs", "pangenome.bs"):
        with open(os.path.join(port_dir, name), "rb") as a, \
                open(os.path.join(ref_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    memo = [
        json.load(open(os.path.join(d, "pangenome.json"))).get("deep_probe")
        for d in (port_dir, ref_dir)
    ]
    assert memo[0] == memo[1]
    assert len(load_stage(port_dir, "pangenome").blocks) > 3


def test_cli_devices_cuda_exits_here(tmp_path, monkeypatch):
    arena = synthetic_arena(n_genomes=2, length=2000, seed=2)
    w = str(tmp_path)
    save_stage(w, "input", BlockSet(arena, []))
    with pytest.raises(SystemExit) as e:  # no GPU at all
        main(["make-pangenome", "-w", w, "--device", "cuda", "--devices", "2"])
    assert e.value.code not in (0, None)
    # one visible card: --devices 2 is an error, not a fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(SystemExit) as e:
        main(["make-pangenome", "-w", w, "--device", "cuda", "--devices", "2"])
    assert "need 2 cuda devices, have 1" in str(e.value.code)
    assert load_stage(w, "pangenome") is None

"""The frozen world generator makes the reference's pinned worlds bit for
bit: the arena digests that chip_smoke.py pins for them."""

import hashlib

import pytest

from portbench import world

PINNED = [
    ({"n_genomes": 17, "genome_length": 1_000_000},
     {"sub_rate": 0.002, "indel_rate": 0.0001, "n_inversions": 3}, 42,
     "e71b5800b914d646423518ffeed8ba4428c170b869fedb5f01a46bb4b7a82208"),
    ({"n_genomes": 100, "genome_length": 150_000},
     {"sub_rate": 0.001, "indel_rate": 0.00005, "n_inversions": 1}, 100,
     "75f33bf60da3a239509f700b2d1f3647339c908528f30bd4b4e9868901f54ec0"),
]


@pytest.mark.parametrize("config,traffic,seed,digest", PINNED,
                         ids=["17x1Mbp", "100x150kb"])
def test_world_matches_pinned_digest(config, traffic, seed, digest):
    _names, seqs = world.make_world(config, traffic, seed)
    codes, offsets = world.concat(seqs)
    assert offsets[-1] == len(codes)
    assert hashlib.sha256(codes.tobytes()).hexdigest() == digest


def test_same_seed_same_world_and_large_seeds():
    cfg = {"n_genomes": 3, "genome_length": 2000}
    traffic = {"sub_rate": 0.01, "indel_rate": 0.001, "n_inversions": 1}
    a = world.concat(world.make_world(cfg, traffic, 2**31 + 12345)[1])[0]
    b = world.concat(world.make_world(cfg, traffic, 2**31 + 12345)[1])[0]
    c = world.concat(world.make_world(cfg, traffic, 2**31 + 12346)[1])[0]
    assert (a == b).all() and not (len(a) == len(c) and (a == c).all())
    with pytest.raises(ValueError):
        world.make_world(cfg, traffic, -1)


def test_a_world_seed_fixes_the_genomes_and_the_seed_their_order():
    cfg = {"n_genomes": 5, "genome_length": 3000}
    traffic = {"world_seed": 42, "sub_rate": 0.01, "indel_rate": 0.001, "n_inversions": 1}
    base = world.make_world(cfg, dict(traffic, world_seed=42), 0)
    fixed = dict(zip(*world.make_world(cfg, {k: v for k, v in traffic.items() if k != "world_seed"}, 42)))
    orders = set()
    for seed in (1, 2, 2**31 + 7):
        names, seqs = world.make_world(cfg, traffic, seed)
        orders.add(tuple(names))
        assert sorted(names) == sorted(base[0])
        for n, s in zip(names, seqs):  # the genomes a world made from seed 42 has
            assert (s == fixed[n]).all()
    assert len(orders) > 1

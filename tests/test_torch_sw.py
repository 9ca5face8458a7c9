"""npge_tpu_torch banded-SW x-drop (plain torch version of the CUDA kernel)
vs the JAX reference: the NumPy mirror, the Pallas kernel in interpret mode
and the unbanded oracle. Every value is an integer: equality is exact."""

import numpy as np
import pytest
import torch

from npge_tpu.ops.sw import sw_extend, sw_extend_reference
from npge_tpu.ops.sw import sw_extend_windows as ref_sw_extend_windows
from npge_tpu_torch.ops import sw as port_sw
from npge_tpu_torch.ops.sw import sw_extend_windows


def planted_pairs(seed: int, P: int, L: int):
    """codes2 with N runs plus P (qb, qcap, tb, tcap) windows whose targets
    are mutated copies (substitutions and indels) of their queries; caps
    include 0 and values above L."""
    rng = np.random.default_rng(seed)
    n = P * 4 * L
    codes2 = rng.integers(0, 4, n).astype(np.uint8)
    for _ in range(P // 2):  # N runs
        a = int(rng.integers(0, n - 30))
        codes2[a : a + int(rng.integers(1, 30))] = 4
    qb = np.arange(P, dtype=np.int64) * 4 * L  # disjoint slots
    tb = qb + 2 * L
    for p in range(P):
        src = codes2[qb[p] : qb[p] + L + L // 2].copy()
        sub = rng.random(len(src)) < 0.03
        src[sub] = (src[sub] + 1) % 4
        for _ in range(int(rng.integers(0, 4))):  # indels
            x = int(rng.integers(0, len(src) - 5))
            if rng.random() < 0.5:
                src = np.delete(src, range(x, x + int(rng.integers(1, 4))))
            else:
                src = np.insert(src, x, rng.integers(0, 4, 2).astype(np.uint8))
        m = min(len(src), 2 * L)
        codes2[tb[p] : tb[p] + m] = src[:m]
    qcap = rng.integers(0, L + L // 2, P)
    tcap = rng.integers(0, L + L // 2, P)
    qcap[0], tcap[1] = 0, 0
    qcap[2], tcap[2] = L + 7, L + 3  # clipped to L
    return codes2, qb, qcap, tb, tcap


def mapped_lists(codes2, qb, qcap, tb, tcap, L):
    qs, ts = [], []
    for p in range(len(qb)):
        q = codes2[qb[p] : qb[p] + min(int(qcap[p]), L)]
        t = codes2[tb[p] : tb[p] + min(int(tcap[p]), L)]
        qs.append(np.where(q >= 4, np.uint8(250), q))
        ts.append(np.where(t >= 4, np.uint8(251), t))
    return qs, ts


@pytest.mark.parametrize("L", [64, 128, 512])
def test_plain_matches_numpy_mirror(L):
    codes2, qb, qcap, tb, tcap = planted_pairs(L, 37, L)
    want = ref_sw_extend_windows(codes2, qb, qcap, tb, tcap, L=L)
    launches = port_sw.SW_LAUNCHES
    got = sw_extend_windows(torch.from_numpy(codes2), qb, qcap, tb, tcap, L=L)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert port_sw.SW_LAUNCHES == launches  # CPU tensors launch nothing
    assert (want[:, 0] > 20).sum() > 10  # the planted homology aligns


def test_plain_matches_pallas_interpret():
    L = 128
    codes2, qb, qcap, tb, tcap = planted_pairs(3, 6, L)
    qs, ts = mapped_lists(codes2, qb, qcap, tb, tcap, L)
    want = sw_extend(qs, ts, L=L, interpret=True)
    got = sw_extend_windows(torch.from_numpy(codes2), qb, qcap, tb, tcap, L=L)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_matches_unbanded_oracle():
    """Pairs shorter than W/2 fit the band: banded == unbanded exactly."""
    L = 64
    codes2, qb, qcap, tb, tcap = planted_pairs(4, 12, L)
    qcap = np.minimum(qcap, 60)
    tcap = np.minimum(tcap, 60)
    got = sw_extend_windows(torch.from_numpy(codes2), qb, qcap, tb, tcap, L=L)
    qs, ts = mapped_lists(codes2, qb, qcap, tb, tcap, L)
    for p in range(len(qs)):
        assert tuple(got[p].tolist()) == sw_extend_reference(qs[p], ts[p]), p


def test_scores_are_parameters():
    """Non-default scores reach the recurrence exactly as in the mirror."""
    L = 64
    codes2, qb, qcap, tb, tcap = planted_pairs(5, 9, L)
    sw = dict(match=2, mismatch=-3, gap=-4, xdrop=30)
    want = ref_sw_extend_windows(codes2, qb, qcap, tb, tcap, L=L, **sw)
    got = sw_extend_windows(torch.from_numpy(codes2), qb, qcap, tb, tcap, L=L, **sw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_empty_batch():
    got = sw_extend_windows(
        torch.zeros(10, dtype=torch.uint8), [], [], [], [], L=64
    )
    assert tuple(got.shape) == (0, 3)


def test_kernel_wrapper_validates_before_launch():
    """The CUDA wrapper refuses what the kernel does not take (band width,
    score range, dtypes) before it builds or launches anything."""
    from npge_tpu_torch.ops.sw import _sw_windows_cuda

    c2 = torch.zeros(100, dtype=torch.uint8)
    b = torch.zeros(2, dtype=torch.int64)
    cap = torch.ones(2, dtype=torch.int32)
    sw = (250, 251)
    with pytest.raises(ValueError, match="W = 128"):
        _sw_windows_cuda(c2, b, cap, b, cap, 64, *sw, 64, 1, -2, -3, 64)
    with pytest.raises(ValueError, match="xdrop"):
        _sw_windows_cuda(c2, b, cap, b, cap, 64, *sw, 128, 1, -2, -3, 1 << 29)
    with pytest.raises(ValueError, match="qcap"):
        _sw_windows_cuda(c2, b, cap.long(), b, cap, 64, *sw, 128, 1, -2, -3, 64)
    launches = port_sw.SW_LAUNCHES
    with pytest.raises(ValueError, match="codes2"):
        _sw_windows_cuda(c2.int(), b, cap, b, cap, 64, *sw, 128, 1, -2, -3, 64)
    assert port_sw.SW_LAUNCHES == launches

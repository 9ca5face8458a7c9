"""npge_tpu_torch.ops.pack (2-bit packing) against the reference's jnp
``pack2`` / ``unpack2``, round trip included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from npge_tpu.ops.pack import pack2 as ref_pack2, unpack2 as ref_unpack2
from npge_tpu_torch.ops.pack import pack2, unpack2


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1000, 4099])
def test_pack_matches_reference_and_round_trips(n):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.random(n) < 0.05] = 4  # N runs of the arena
    packed, mask = pack2(torch.from_numpy(codes))
    want_packed, want_mask = ref_pack2(jnp.asarray(codes))
    assert packed.dtype == torch.uint32 and packed.shape == (-(-n // 16),)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want_packed))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    back = unpack2(packed, mask)
    assert back.dtype == torch.uint8
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref_unpack2(want_packed, want_mask))
    )

"""Hand a world of the JAX reference to the port as arrays and text only
(``npge_tpu_torch.carry``), for the port's tests: the port never receives
an object of the reference."""

import dataclasses
import io
import json

from npge_tpu.io.bs import write_blockset
from npge_tpu_torch.carry import arena_from_arrays, blockset_from_bs_text
from npge_tpu_torch.config import Config


def port_arena(arena):
    """The port's copy of a reference arena."""
    return arena_from_arrays(
        arena.names, [arena.seq_codes(i) for i in range(arena.n_seqs)]
    )


def port_blockset(bs):
    """The port's copy of a reference blockset, through the reference's
    ``.bs`` writer and the port's reader."""
    fh = io.StringIO()
    write_blockset(fh, bs)
    return blockset_from_bs_text(port_arena(bs.arena), fh.getvalue())


def port_config(cfg):
    """The port's copy of a reference config, through its JSON dict."""
    return Config.from_dict(json.loads(cfg.to_json()))


def fields(rep):
    """A report dataclass as a plain dict, to compare across packages."""
    return dataclasses.asdict(rep)

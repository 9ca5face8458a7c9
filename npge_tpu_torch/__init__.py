"""npge_tpu_torch — the pangenome engine on PyTorch and CUDA (NVIDIA Hopper).

A second package beside ``npge_tpu``, which stays the reference. It takes the
reference's own ``GenomeArena`` and ``Config`` objects, reuses its jax-free
host stages (model, io, util, native, and the algo stages resolve admission,
join, rest, consensus, surgery) by import, and carries its own copies of the
few host functions that live in jax modules. It never imports ``jax``.

  - ``device``  explicit device resolution and the arena upload
  - ``ops``     device compute: k-mer scan (``kmers``), gapless lockstep
                extension (``extend``), banded-SW x-drop (``sw``, a CUDA
                kernel for sm_90a, built at first use by ``_build``)
  - ``algo``    the stages of the default ``make-pangenome`` build
  - ``cli``     ``prepare`` and ``make-pangenome``
"""

__version__ = "0.1.0"

# the reference's host objects the port takes as they are, and the build
from npge_tpu.algo.is_pangenome import check_is_pangenome  # noqa: E402,F401
from npge_tpu.config import Config, default_config  # noqa: E402,F401
from npge_tpu.model.arena import GenomeArena  # noqa: E402,F401
from npge_tpu.model.hashing import blockset_hash  # noqa: E402,F401
from npge_tpu.native import have_native  # noqa: E402,F401
from npge_tpu.util.synthetic import synthetic_arena  # noqa: E402,F401
from npge_tpu_torch.algo.pangenome import build_pangenome  # noqa: E402,F401

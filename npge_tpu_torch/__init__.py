"""npge_tpu_torch — the pangenome engine on PyTorch and CUDA (NVIDIA Hopper).

A second package beside ``npge_tpu``, which stays the reference. It stands
alone: it imports neither ``jax`` nor ``npge_tpu``. Its host modules
(``config``, ``model``, ``io``, ``util``, ``native`` with its C++ library,
and the host stages of ``algo``) are copies of the reference's, each naming
its original in a ``# mirrors`` line; ``carry`` hands a reference world to
the port as numpy arrays and text.

  - ``config``, ``model``, ``io``, ``util``, ``native``  host copies
  - ``device``  explicit device resolution and the arena upload
  - ``ops``     device compute: k-mer scan (``kmers``), gapless lockstep
                extension (``extend``), banded-SW x-drop (``sw``, a CUDA
                kernel for sm_90a, built at first use by ``_build``), 2-bit
                packing (``pack``)
  - ``parallel`` a device mesh in one process (``mesh``, ``sharded``) and
                a build split across a ``torch.distributed`` group of
                processes (``distributed``, gloo gathers)
  - ``algo``    every stage of ``make-pangenome`` and post-processing, the
                IsPangenome check with its deep probe, and gene mapping
                (``genes``)
  - ``meta``    the processor registry (``run``, ``processors``, ``shell``)
  - ``cli``     every verb of ``npge_tpu.cli``, with ``--device``
"""

__version__ = "0.1.0"

from npge_tpu_torch.config import Config, default_config  # noqa: E402,F401
from npge_tpu_torch.io.checkpoint import save_stage  # noqa: E402,F401
from npge_tpu_torch.model.arena import GenomeArena  # noqa: E402,F401
from npge_tpu_torch.model.blocks import BlockSet  # noqa: E402,F401
from npge_tpu_torch.model.hashing import blockset_hash  # noqa: E402,F401
from npge_tpu_torch.native import have_native  # noqa: E402,F401
from npge_tpu_torch.util.synthetic import synthetic_arena  # noqa: E402,F401
from npge_tpu_torch.algo.is_pangenome import check_is_pangenome  # noqa: E402,F401
from npge_tpu_torch.algo.pangenome import build_pangenome  # noqa: E402,F401

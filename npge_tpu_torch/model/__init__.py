# mirrors npge_tpu/model/__init__.py
from npge_tpu_torch.model.arena import GenomeArena, SeqName  # noqa: F401
from npge_tpu_torch.model.blocks import Block, BlockSet  # noqa: F401

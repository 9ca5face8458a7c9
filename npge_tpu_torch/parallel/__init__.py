"""Parallel builds: a device mesh in one process (``mesh``, ``sharded``) and
a build split across the processes of a ``torch.distributed`` group
(``distributed``). Both give the single-device blockset."""

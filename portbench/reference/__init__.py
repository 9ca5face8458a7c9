"""Plain references of the pangenome build's layers, in NumPy and torch.

Each module states the semantics it checks and imports nothing of the
program under test, of ``jax`` or of the JAX package.
"""

"""portbench: the benchmark of npge_tpu_torch on NVIDIA GPUs (see README.md)."""

"""Attention kernels: hand-written Hopper kernels (``csrc/``), their plain
PyTorch versions, and the dispatch layer in :mod:`.ops`."""

"""Attention kernels of the serving path: hand-written CUDA C++ for Hopper
(``csrc/``), each beside its plain PyTorch version (``ref.py``), with the
device dispatch in ``ops.py``."""

"""Hand-written CUDA kernels and their plain PyTorch versions.

``charge_replay`` replaces the JAX package's Pallas lane kernel
``repro/kernels/charge_replay.py:pallas_replay``.  Kernels build at first
use (``_build``); importing this package builds nothing.
"""

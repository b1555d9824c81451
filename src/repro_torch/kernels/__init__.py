"""Hand-written CUDA kernels and their plain PyTorch versions.

  charge_replay -- the fleet replay's lane kernel (replaces
                   ``repro/kernels/charge_replay.py:pallas_replay``)
  dense_matmul  -- tiled matmul, SONIC's loop-ordered accumulation
                   (replaces ``repro/kernels/dense_matmul.py:matmul``)
  sparse_fc     -- GENESIS's block-CSR pruned FC (replaces
                   ``repro/kernels/sparse_fc.py:block_sparse_matvec``)
  fir_conv1d    -- TAILS's FIR-DTC analogue, depthwise 1-D taps (replaces
                   ``repro/kernels/fir_conv1d.py:fir_conv1d``)
  calibrate     -- TAILS-style tile calibration against shared memory

The entry points ``dense_matmul``, ``BlockSparseFC`` and ``fir_conv1d``
(``ops``) are exported here, as in the JAX package, so the names
``dense_matmul`` and ``fir_conv1d`` on this package are those functions:
reach the kernel modules by their full path
(``importlib.import_module("repro_torch.kernels.fir_conv1d")``).  Kernels
build at first use (``_build``); importing this package builds nothing.
"""

from . import ref
from .calibrate import (MatmulTiles, SMEM_BUDGET_BYTES, fir_tiles,
                        matmul_tiles)
from .ops import BlockSparseFC, dense_matmul, fir_conv1d

__all__ = ["BlockSparseFC", "MatmulTiles", "SMEM_BUDGET_BYTES",
           "dense_matmul", "fir_conv1d", "fir_tiles", "matmul_tiles", "ref"]

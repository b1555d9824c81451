"""Hand-written CUDA kernels and their plain PyTorch versions.

  charge_replay -- the fleet replay's lane kernel (replaces
                   ``repro/kernels/charge_replay.py:pallas_replay``)
  closed_form   -- the deterministic replay's closed form, one thread a
                   lane over every row (XLA's fused scan in the JAX
                   package; no Pallas kernel)
  dense_matmul  -- tiled matmul, SONIC's loop-ordered accumulation
                   (replaces ``repro/kernels/dense_matmul.py:matmul``)
  sparse_fc     -- GENESIS's block-CSR pruned FC (replaces
                   ``repro/kernels/sparse_fc.py:block_sparse_matvec``)
  fir_conv1d    -- TAILS's FIR-DTC analogue, depthwise 1-D taps (replaces
                   ``repro/kernels/fir_conv1d.py:fir_conv1d``)
  flash_attention -- online-softmax attention, causal tile skip (replaces
                   ``repro/kernels/flash_attention.py:flash_attention``)
  ssd_intra     -- Mamba2 SSD intra-chunk cell, decay never in HBM
                   (replaces ``repro/kernels/ssd_intra.py:ssd_intra``)
  calibrate     -- TAILS-style tile calibration against shared memory

The entry points ``dense_matmul``, ``BlockSparseFC``, ``fir_conv1d``,
``flash_attention`` (``ops``) and ``ssd_intra`` are exported here, as in
the JAX package, so the names ``dense_matmul``, ``fir_conv1d``,
``flash_attention`` and ``ssd_intra`` on this package are those functions:
reach the kernel modules by their full path
(``importlib.import_module("repro_torch.kernels.fir_conv1d")``).  Kernels
build at first use (``_build``); importing this package builds nothing.
"""

from . import ref
from .calibrate import (MatmulTiles, SMEM_BUDGET_BYTES, fir_tiles,
                        matmul_tiles)
from .ops import BlockSparseFC, dense_matmul, fir_conv1d, flash_attention
from .ssd_intra import ssd_intra

__all__ = ["BlockSparseFC", "MatmulTiles", "SMEM_BUDGET_BYTES",
           "dense_matmul", "fir_conv1d", "fir_tiles", "flash_attention",
           "matmul_tiles", "ref", "ssd_intra"]

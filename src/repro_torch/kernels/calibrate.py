"""TAILS-style kernel tile calibration, for the H100's shared memory.

The paper's LEA can only compute out of a 4 KB SRAM staging buffer; TAILS
calibrates the largest DMA tile that completes within one charge (Sec. 7.1)
by halving it until it fits.  On an H100 a thread block computes out of
its shared memory: 48 KB without opting in, at most 227 KB (232,448 bytes)
with ``cudaFuncSetAttribute``.  This module picks the largest tiles the
port's kernels can launch with whose shared-memory working set fits the
budget, halving one dimension at a time -- the same recursive-halving
discipline as the paper, with the energy buffer replaced by shared memory.

The alignment is the kernels' own granularity, not the TPU's 8 x 128:
``csrc/dense_matmul.cu``'s CUDA-core kernel gives each thread an 8 x 8
micro-tile of the output (:data:`TILE`), so its bm and bn are multiples of
8 and a 128 x 128 tile takes its 256 threads; ``csrc/fir_conv1d.cu``'s
first (tiled) design runs 256 threads over a block of channels x output
positions (its flat design, the main path's, runs tiles of its own, see
``fir_conv1d.fir_path``).  The tiles returned here are the ones those
kernels launch with.  The matmul's
tensor-core kernels run their own tiles (128 x 128 outputs fed by a
4-stage ring: 64-wide K slices for bf16 on wgmma, 32-wide for f32 as
3xTF32, whose split over K ``dense_matmul.tf32x3_plan`` chooses), so
:func:`matmul_tiles` does not size them; the tiles are still checked when
they run.  This is the one module of the port whose numbers differ from
the JAX package's by design.
"""

from __future__ import annotations

from dataclasses import dataclass

#: Static shared memory of one thread block: the default budget.
SMEM_BUDGET_BYTES = 48 * 1024
#: The most shared memory one block can opt into on an H100.
SMEM_MAX_BYTES = 232_448
#: SMs of an H100 SXM: what a grid of one block an SM covers.
SMS = 132

#: The matmul kernel's micro-tile edge (outputs a thread owns per side).
TILE = 8
#: Threads of one matmul block at most (64 f32 accumulators each).
MATMUL_MAX_THREADS = 256
#: Largest bm and bn: (128 / 8)^2 = 256 threads.
MAX_BMN = 128
#: Largest bk the calibration starts from.
MAX_BK = 256

#: Threads of one FIR block (channels x positions) at most, the narrowest
#: row of positions a block runs (one warp), and the taps staged per step.
FIR_THREADS = 256
WARP = 32
FIR_TAP_SLICE = 32


def _align_up(x: int, a: int) -> int:
    return max(a, -(-x // a) * a)


def _align_down(x: int, a: int) -> int:
    return max(a, (x // a) * a)


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


@dataclass(frozen=True)
class MatmulTiles:
    bm: int
    bk: int
    bn: int

    def working_set(self, bytes_per_el: int = 4) -> int:
        """Shared memory of one block of ``csrc/dense_matmul.cu``: a bk
        slice of x (rows padded to bm + 1) and of w, in the input type; the
        f32 accumulators live in registers."""
        return bytes_per_el * ((self.bm + 1) * self.bk + self.bk * self.bn)

    @property
    def threads(self) -> int:
        return (self.bm // TILE) * (self.bn // TILE)


def matmul_tiles(m: int, k: int, n: int, bytes_per_el: int = 4,
                 budget: int = SMEM_BUDGET_BYTES) -> MatmulTiles:
    """Largest aligned tiles whose working set fits ``budget`` (halving
    to fit): bk first, since it only sets how often a block synchronises,
    then the larger of bn and bm, which set how often a loaded word is
    reused."""
    t = MatmulTiles(min(MAX_BMN, _align_up(m, TILE)),
                    min(MAX_BK, _align_up(k, TILE)),
                    min(MAX_BMN, _align_up(n, TILE)))
    while t.working_set(bytes_per_el) > budget:
        if t.bk > TILE:
            t = MatmulTiles(t.bm, _align_down(t.bk // 2, TILE), t.bn)
        elif t.bn >= t.bm and t.bn > TILE:
            t = MatmulTiles(t.bm, t.bk, _align_down(t.bn // 2, TILE))
        elif t.bm > TILE:
            t = MatmulTiles(_align_down(t.bm // 2, TILE), t.bk, t.bn)
        else:
            break
    return t


def fir_width(length: int) -> int:
    """Output positions of one FIR block: the row length rounded up to a
    power of two, at least a warp and at most :data:`FIR_THREADS`."""
    return min(FIR_THREADS, max(WARP, _pow2_ceil(length)))


def fir_working_set(cb: int, tw: int, bytes_per_el: int = 4) -> int:
    """Shared memory of one block of ``csrc/fir_conv1d.cu``: per channel a
    window of tw positions plus a tap slice's halo, and the tap slice."""
    return bytes_per_el * cb * (tw + 2 * FIR_TAP_SLICE - 1)


def fir_tiles(channels: int, length: int, bytes_per_el: int = 4,
              budget: int = SMEM_BUDGET_BYTES) -> int:
    """Channel-block size cb for the FIR kernel: as many channels as fill
    :data:`FIR_THREADS` threads beside :func:`fir_width` positions, no more
    than there are channels, halved until the working set fits."""
    tw = fir_width(length)
    cb = min(FIR_THREADS // tw, _pow2_ceil(channels))
    while cb > 1 and fir_working_set(cb, tw, bytes_per_el) > budget:
        cb //= 2
    return cb

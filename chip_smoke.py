#!/usr/bin/env python3
"""Drive the PyTorch port's fleet replay, the paper's end-to-end
demonstration, compute kernels, LM forward, LM serving, the MoE and vlm
families, LM training, the hybrid and encdec families and the sharded LM
launch path on one CUDA card and check them.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It imports the port (``src/repro_torch``), torch and numpy only, and
prints one JSON line per phase; any failure exits non-zero.

1. device  -- the card's name and count, and its ``nvidia-smi`` name and
   power limit.  With no card visible the script exits non-zero at once.
2. build   -- nvcc builds every kernel from the checkout's sources (the
   lane kernel, the closed form, the statistics fold and the five compute
   kernels; one nvcc per source, all started together) and prints the
   ptxas register and spill lines, and each lane-kernel and closed-form
   instantiation's and narrow matmul kernel's registers, spill bytes and
   stack frame; for the Hopper
   kernels (the matmul's bf16 and 3xTF32
   kernels, the bf16 attention kernel, the block-sparse FC's bf16 and
   3xTF32 kernels and the SSD cell's 3xTF32 kernel, on ``wgmma`` fed by
   TMA) it prints each one's registers and spill bytes
   and, where the toolkit has ``cuobjdump``, the HGMMA and UTMALDG
   instructions in its SASS, and fails if either count is 0 or a spill
   byte is reported (where ``cuobjdump`` is missing it says so on a
   line).  It also builds the SSD cell's comparison variant, x dt fed by
   its threads' loads (``ssd_intra_thread_fed``), timed in phase 9.
3. kernel_vs_plain -- small random networks (seeded numpy) through the
   entry points, covering the flag combinations the tests cover (and a
   ``PlanSet`` of five of their plans, the lane kernel in plan mode); every
   kernel launch's inputs are replayed through the plain PyTorch version
   and through the lane kernel's direct design on the card, and every
   output channel must agree bitwise.
4. full_width -- the main path at the published widths: ``fleet_sweep``
   of ``mnist_net()`` under tails/adaptive, sonic/fixed and tails with the
   uplink radio, over thousands of devices.  Launch counts are zeroed
   just before and read just after; every run must have launched the
   hoisted design and none the direct one.  Each run is relaunched on its
   inputs with both designs, held bitwise, and each design timed (median
   of 5 launches: ``ms`` and ``previous_ms``), beside the throughput bound
   and the chain floor (the longest lane's rows x the dependent f64
   operations on an event's shortest path x the f64 add's latency, which
   a one-thread kernel measures on the card in SM cycles beside the SM
   clock).  The kernel is held against the plain version on the first
   run's inputs, and a full-width ``har_net()`` replay against the direct
   design (every lane) and the plain version (its first 4 lanes).
5. (part of 4) har_first_lanes.  Then design_sweep: a ``PlanSet`` of
   ``mnist_net()``'s {tile-32, sonic, tails} x {100uF, 1mF} plans (the JAX
   package's design_space grid with tile-32 for tile-8), 4,096 devices a
   candidate, seed 7, charge cv 0.25, 64 charges, 16 recharges: launch
   counts zeroed just before and read just after, every launch on the
   hoisted design in plan mode; each candidate bitwise equal to its own
   ``fleet_sweep``, the launch relaunched on the direct design (bitwise)
   and timed (median of 3), ``reduce="stats"`` of the sweep bitwise equal
   to ``stats_from_outputs`` of its lanes; its rows, table bytes and the
   six solo launches' ms.  Then streamed_stats: ``fleet_sweep`` of
   ``mnist_net()`` under tails/1mF adaptive with ``reduce="stats"`` in
   65,536-lane chunks, at 262,144 lanes (one warm-up run at prefetch 0 and
   one at 1, then the two in turns, the minimum of 2 a mode: bitwise
   equal, and prefetch 1 at least ``OVERLAP_FLOOR`` = 0.95 times as fast)
   and 1,048,576 (prefetch 1), counts zeroed before and read after each
   (one fold and one lane-kernel launch a chunk), host seconds by thread
   and function (wall and CPU, from the program's spans: ``host_report``)
   and the peak device memory
   over its baseline, which must agree within 10 % between the two sizes;
   the fold kernel bitwise
   against its plain version (on the host) on one chunk's outputs, timed
   beside its bound (the bytes at 3.35 TB/s) and the lane-order chain
   (lanes x the f64 add's latency); a ``capacitor_sweep`` of the
   parametric tails plan over 5 capacitors x 4,096 devices, its
   ``reduce="stats"`` groups bitwise equal to ``stats_from_outputs`` of
   its lanes.  Then closed_form: the closed form's kernel on one call's
   inputs of a ``reduce="stats"`` query of ``mnist_net()`` under tails/1mF
   (nominal charges) at 8,192 and 16,384 lanes, one launch and the plan's
   rows counted over the query itself (zeroed just before, read just
   after), timed (median of 5) beside the aten per-row CUDA graph it
   replaced (``previous_ms``) and its bound by operations, bitwise equal
   to the graph on every channel and, at 8,192 lanes, to the CPU's row
   loop (``plain_ms``).  Then overlap: the JAX package's own
   overlap protocol and
   gate (``benchmarks/fleet.py`` ``_overlap_comparison``) through the port
   -- its device network rebuilt from its seed, sonic/1mF, seed 7,
   ``reduce="stats"``, 256 recharges a lane, 100,000 lanes in 8,192-lane
   chunks (the closed-form scan), one warm-up, the minimum of 2 runs at
   prefetch 0 then at 1: bitwise equal, with the sampler fraction, both
   peaks, the single-chunk footprint, host seconds by thread and
   function and the host's cores and thread pools; it fails below 0.95x
   or above twice the footprint.  Then genesis: GENESIS end to end --
   ``sweep`` of ``mnist_net()`` over the JAX benchmark's fig4_5 MNIST
   task (768 / 256 samples, noise 0.85, 2 epochs, 10 configurations):
   every candidate retrained on the card (TF32 off), the grid priced by
   one plan-mode launch of the lane kernel and one fold (counts zeroed
   just before the sweep and read just after), then ``pareto_frontier``
   and ``select`` (non-empty, within ``DEVICE_WEIGHT_BYTES``); the
   pricing bitwise against the same sweep with ``device="cpu"``; the
   closed-form scan timed on the sweep's PlanSet (median of 5 between
   CUDA events; the closed form's kernel in plan mode) and held bitwise
   against the CPU's loop; the chosen configuration's first 8 training
   steps on the card against the CPU's (``TRAIN_RTOL``, ``TRAIN_ATOL`` on
   float64 weights and inputs; the float32 distance reported); and the
   JAX benchmark's svm_vs_dnn MNIST pair (``train_svm`` and ``svm_impj``
   against ``train`` of the compressed net and ``estimate_energy``, one
   launch of the closed form's kernel, counted from just before it to
   just after).  It prints ``PYTHONHASHSEED``, on which ``make_task``'s data depends.
   Then while_oracle: the legacy ``backend="_while"`` oracle (a row scan
   with a data-dependent charge loop a row, eager on the card) on a small
   seeded network with charge jitter (cv 0.25, 16 charge draws, 64 lanes
   a run): tails adaptive (batch_rows=2), sonic fixed, tails with the
   uplink under the topk-hedge radio and a 3-candidate ``PlanSet`` design
   sweep, each bitwise against ``backend="cuda"`` (the lane kernel) and
   ``backend="torch"`` on every channel, with each backend's wall time
   and the oracle's charge steps.  Then mesh: ``make_fleet_mesh()`` (a
   ``(1,)`` mesh on one card) under ``fleet_sweep`` of ``mnist_net()``
   (tails/1mF adaptive, charge cv 0.25, 16,387 lanes) with
   ``reduce="none"``, ``"stats"`` and ``"stats"`` in 4,096-lane chunks,
   and a ``capacitor_sweep`` of 5 capacitors x 1,024 devices with
   ``reduce="stats"``: each bitwise against the call without ``mesh=``,
   with both walls, the shard count and the launches of the lane kernel
   and the fold (counted from just before each meshed run to just after;
   they join the kernels line's ``launches``).  With more than one card
   the mesh over every card is also held to the multi-shard rule.  Then
   paper_demo: ``examples/intermittent_mnist_torch.py`` (the paper's
   demonstration: GENESIS-compressed MNIST retrained, Fig. 9's 6 x 4
   matrix, a 1,000-device fleet, the uplink under three send policies, a
   15-candidate ``PlanSet`` design space in one plan-mode launch, the
   adaptive-commit risk sweep over 256 devices, a million-device
   ``reduce="stats"`` query in 8,192-lane chunks) at ``--scale 0.1`` (a
   tenth of those devices, printed as ``reduced``) in its own process:
   exit code 0, every section's header, SONIC and TAILS
   finishing on every power system, no wasted cycles at charge cv 0 and
   some at 0.8, one plan-mode launch, and the query's peak lane buffer
   equal to the same call's over 65,536 lanes; its section walls and its
   launches of the lane kernel (by row mode), of the fold and of the
   closed form, which join the kernels line's.  Beside it this process
   computes on the card, and a worker process started after the build on the CPU, the Fig. 9
   matrix of the compressed net and the design space's sweep at 8
   devices a candidate, held bitwise against each other (all 24
   ``RunResult``s; the ``summary()`` rows).
6. kernels_vs_plain -- the ``repro_torch.kernels`` entry points
   (``dense_matmul``, ``BlockSparseFC``, ``fir_conv1d``) at small seeded
   shapes (odd sizes, explicit tiles, f32, bf16 and both mixed pairs, an
   empty row-block, batches off the batch tile, K = 1 and K = L), each
   output held against its kernel's plain version on the card (the FIR
   bitwise in every dtype pair, on the kernel ``fir_path`` names and, where
   that is the flat one, on the tiled first design too, over L = 1, K = L,
   tiles that end mid-row with spans off 16-byte boundaries, the largest
   K of the flat design and the next, and x off a 16-byte boundary); each
   matmul and block-sparse case and each FIR case prints the
   kernel that took it (``path``: for the matmul ``wgmma`` for aligned
   bf16 and ``tf32x3`` for aligned f32 and mixed pairs, also with ragged
   M, N and K and K split over 2 or 4 CTAs, ``narrow`` for N up to 64
   otherwise (held bitwise against the CUDA-core kernel too), ``simt``
   for the rest and, named, at explicit tiles; for the block-sparse FC
   ``wgmma`` for bf16
   and ``tf32x3`` for f32 and mixed pairs in 128-row blocks, ``simt`` for
   other blocks and, named, for the 128-row ones too) and the largest
   share of its limit, and fails if it is not the one its shape calls
   for.  The f32 outputs of the 3xTF32 kernels are also held to the
   ``tf32x3`` rule against the f64 product, and each ``tf32x3`` matmul is
   run twice and must give the same bits.
7. kernels_full_width -- the same entry points at the repo's benchmark
   shapes, through ``mnist_net()`` at its published widths over a batch
   of 1024 inputs (convolutions composed from FIRs, fc1 pruned to 90 %
   and block-sparse, fc2/fc3 dense), and at one large shape per kernel.
   Launch counts are zeroed just before and read just after; each kernel
   must have launched.  Then every output is held against the plain
   version (and the MNIST logits against the plain chain and the numpy
   simulator), and the kernel, its plain version and one PyTorch library
   call computing the same function are timed, beside the bound.  The
   4096^3 and 512 x 1024 x 768 f32 products and MNIST's fc2 must go
   through the tf32x3 kernel (each prints its tiles and split, and gives
   the same bits when run again), the 4096^3 bf16 product through the
   wgmma kernel, MNIST's fc3 (N = 10) through the narrow one (also timed
   alone at that shape, bitwise against the CUDA-core kernel, which is
   its ``previous_ms``), and the 4096^2 block-sparse FC through the
   tf32x3 kernel in f32 and the wgmma one in bf16 (and MNIST's fc1
   through tf32x3); each tensor-core run is timed beside the CUDA-core
   kernel it replaced (``previous_ms``), at the same shape in the same
   run.  Each matmul and its library call are also timed replayed from a
   CUDA graph (``graph_ms``, ``library_graph_ms``): the device's time
   without the host's.  MNIST's 105 FIR launches must all take the flat
   kernel (``mnist_fir_launches_by_path``); the FIR is timed at MNIST's two
   convolutions as the chain stacks them (conv1: 491,520 rows of 28;
   conv2: 819,200 rows of 12) and at 8192^2 in f32 and bf16, each bitwise
   against and timed beside the tiled first design (``previous_ms``) and
   the flat kernel's own looped-K instantiation (``looped_ms``: what the
   unrolled K = 5 one saves), with
   ``F.conv1d`` (groups = C) as the library call; the benchmark's 128 x 512
   (32 tiles, fewer than SMs) takes the tiled one and is timed beside the
   flat one by name (``flat_ms``); each FIR row is also timed from CUDA
   graphs (``graph_ms``, ``previous_graph_ms``, ``flat_graph_ms``,
   ``looped_graph_ms``).  Then
   ``narrow_sweep``: the narrow and CUDA-core kernels at M = 1024, K = 500
   and N = 1, 10, 16, 32 and 64, bitwise and timed (where the narrow one
   is faster, ``matmul_path`` may send N to it).
8. lm_vs_plain -- the attention kernels (f32 and bf16, causal or not,
   Sq != Sk, S of 1, 37, 300 and 1,500 keys, d of 40, 64, 80, 112
   (zamba2-7b's heads), 120 and 128, all on the wgmma kernel in bf16, the
   widths other than 64 and 128 on the mma.sync one too, by name, on the
   same operands, GQA group 2) and the SSD cell (the
   tests' shapes, an overflowing decay, Q = 256, 192, 128 and 64 (one row
   tile), N = 64, 128 and 192, 17 heads and one head, in f32, bf16 and
   three mixes) against their plain
   versions on the card, attention's at the tiles of the kernel that took
   it; each case prints that kernel (``path``); an SSD case on the wgmma
   kernel also runs the first design and the thread-fed variant by name,
   and holds the wgmma outputs to the ``ssd_f64`` rule against the f64
   cell.
9. lm_full_width -- qwen3-0.6b as published (28 layers, bf16, attention
   through the kernel) over 2 x 4,096 tokens: the attention kernel's
   launches zeroed just before ``forward`` and read just after (one a
   layer, all on the wgmma kernel), the logits held against the blockwise
   path in bf16 and, on the
   same weights widened to f32, in f32; the forward timed and split
   (hidden states, LM head) beside its bound.  Then each kernel at its
   full-width shape (one layer's attention; the SSD cell at mamba2-370m's
   widths, reached through the ``kernels`` entry point, launches counted
   by kernel and all on the wgmma one, then on bf16 inputs)
   against its plain version, timed beside its plain version, its bound
   and, for attention, ``scaled_dot_product_attention`` as a yardstick and
   the ``mma.sync`` kernel it replaced (``previous_ms``); the SSD cell
   also against the f64 cell (``ssd_f64``), timed beside the first design
   (``previous_ms``) and the thread-fed variant (``thread_fed_ms``, both
   rules too), with its bounds: the tensor cores' tf32 products
   with G counted once a batch*chunk (``bound_ms``), that count on the
   CUDA cores, the first design's count (G once a cell) and the bytes;
   then at 1 to 512 cells (``small_cells``), the wgmma kernel at the
   heads a CTA ``ssd_plan`` gives beside the first design, and from CUDA
   graphs at 1, 2, 4 and 8 heads a CTA beside the first design.
10. serving -- the card's name and power limit, then qwen3-0.6b as
   published (28 layers, bf16, the same weights, attention through the
   kernel): ``prefill`` of 2 x 4,096 tokens into a 4,160-slot cache, the
   attention kernel's launches zeroed just before and read just after (one
   a layer, all on the wgmma kernel), its last logits and 32
   teacher-forced ``decode_step``s each held against one forward over the
   4,128 tokens at that position (``lm_bf16``); prefill ms, decode ms a
   step (device and host), tokens/s and a step's byte bound (weights and
   the valid K/V at 3.35 TB/s), the decode step's f32 LM head alone.
   ``ServeEngine`` (4 requests, 64-token prompts, 32 new tokens) twice and
   preempted after 8 tokens then resumed by a fresh engine on the same
   state: the tokens equal bit for bit; each run's wall split into decode
   and cursor commits.  Then mamba2-370m as published (48 layers, bf16):
   ``forward`` over 2 x 4,096 tokens with ``ssd_intra``'s launches zeroed
   just before and read just after (one a layer, all on the wgmma kernel),
   each launch held at once against the plain cell on its inputs (``ssd``
   and ``ssd_f64``), the logits against the same forward with the plain
   cell swapped into ``models.mamba2`` for that run only (``lm_bf16``);
   teacher-forced decode over 2 x 256 tokens against the forward in bf16
   and, on the weights widened and made live (``live_ssd``: the init
   recipe leaves the SSD's output 1e-6 of the skip path's), over 2 x 64 in
   f32 (``TOLERANCES``); its engine
   (2 requests, 32-token prompts, 16 new tokens) as above; forward ms and
   the SSD cell's ms a launch.  The phase's launches join the kernels
   line's (``serving_launches``).
11. moe -- qwen3-moe-30b-a3b at full width (bf16, seed 0), its depth cut
   to 12 of 48 layers (printed as ``reduced``; no kernel or routing shape
   depends on depth): ``forward`` of 2 x 2,048 tokens with the flash
   kernel's launches zeroed just before and read just after (one a
   layer, all on wgmma), against the same forward with the plain
   attention (``lm_bf16``), each MoE block's routing recorded in both
   (token-slots routed elsewhere; the share dropped at capacity factor
   1.25); ``prefill`` of those tokens against the forward's last logits;
   16 teacher-forced ``decode_step``s at batch 4 twice, bitwise, with ms
   and aten calls a step; its ``ServeEngine`` (4 x (64 + 32) tokens)
   twice and across preemption, bitwise; one layer's ``moe_block``
   against ``moe_block_dense_ref`` at a capacity that drops nothing, and
   its ms beside one attention layer's.  Then llama4-scout-17b-a16e
   (top-1 and the shared expert) at full width, 2 of 48 layers: one
   forward of 1 x 2,048 tokens, kernel against plain.
12. vlm -- internvl2-26b at full width, 2 of 48 layers: ``forward`` and
   ``loss_fn`` over 2 x (256 patch embeddings + 1,792 tokens), kernel
   against plain.
13. train -- qwen3-0.6b as published: ``launch.train.train`` for 4 steps
   at 4 x 1,024 tokens (each step's loss, ms, tokens/s, peak memory,
   flash launches: one a layer and one a layer again in the remat
   recompute; each checkpoint write's s); at full width and 2 of 28
   layers, a run failed at step 3 and resumed: its final parameter and
   optimizer files equal an uninterrupted run's at that depth byte for
   byte; one ``loss_fn`` backward with the kernel against the
   plain attention, every leaf's ||g_kernel - g_plain|| / ||g_plain|| <=
   2e-2; ``train_microbatched`` at full width and 2 of 28 layers (2 steps
   of 4 x 1,024 tokens in 2 microbatches; ms a microbatch, the f32
   accumulator commit's s, 4 flash launches a microbatch, all on wgmma):
   a run failed just before microbatch (1, 1) and resumed runs exactly
   one microbatch, ends with the cursor at (2, 0) and on the
   uninterrupted run's files byte for byte, and step 0's mean
   accumulated gradient is within 2e-2 a leaf of the whole batch's.
   mamba2-370m as published: 2 steps at 2 x 1,024 (96
   ``ssd_intra`` launches a step), its gradient against the plain
   cell's, the same rule.  Each phase prints the card's ``nvidia-smi``
   name and power limit and frees its weights before the next.
14. hybrid -- zamba2-7b at full width (d_model 3,584, 32 heads of 112,
   112 SSD heads, ssm_state 64, bf16, seed 0), 15 of 81 layers (two
   super-blocks of six mamba blocks and the shared block, then the
   published tail of 3; printed as ``reduced``): ``forward`` of 2 x 4,096
   tokens with both kernels' launches zeroed just before and read just
   after (2 flash launches, all on ``wgmma``; 15 ``ssd_intra``, all on
   wgmma, each held at once against the plain cell, ``ssd`` and
   ``ssd_f64``), the logits against the plain attention and plain cell's
   (``lm_bf16``), ms and tokens/s beside ``counting.model_flops``; 32
   teacher-forced ``decode_step``s against the forward
   (``ssm_decode_bf16``), ms and aten calls a step; its ``ServeEngine``
   (4 x (64 + 32)) twice and across preemption, bitwise; one ``loss_fn``
   backward at 7 layers over 2 x 1,024 through both kernels' autograd
   against the plain versions' (every leaf within 2e-2); the attention
   kernel alone at q (64, 4,096, 112) causal and the SSD cell at 3,584
   cells, each beside its plain version, its bound and (attention)
   ``scaled_dot_product_attention`` and the ``mma.sync`` kernel by name
   (``previous_ms``).
15. encdec -- whisper-small as published (12 + 12 layers, 12 heads of
   64, bf16, seed 0) over 2 x (1,500 seeded frame embeddings + 448
   tokens): ``forward`` with the flash launches zeroed just before and read
   just after (24, all on wgmma: 12 non-causal over 1,500 keys, 12 causal
   over 448), the logits against the plain attention's (``lm_bf16``),
   ``encode`` and ``forward`` ms; ``prefill_cross`` then 32 teacher-forced
   ``decode_step``s against the forward (``lm_bf16``), ms and aten calls a
   step; one ``loss_fn`` backward against the plain attention's (2e-2 a
   leaf); the kernel alone at q (24, 1,500, 64) non-causal beside SDPA,
   its bound and the mma.sync kernel by name.  No engine: the JAX
   package's engine never fills the cross K/V (ROADMAP Queue 3 item 8).
16. lm_mesh -- qwen3-0.6b at full width, 2 of 28 layers (bf16, remat
   "full", the flash kernel; printed as ``reduced``): ``launch.train.train``
   for 2 steps at 4 x 1,024
   tokens, a checkpoint at the end, once with ``mesh=None`` and once with
   ``mesh=make_host_mesh((1, 1))`` (parameters as their ``tree_specs``
   blocks, the AdamW moments as ZeRO-1 blocks), the flash launches zeroed
   just before each run and read just after (4 a step, all on wgmma:
   forward and remat recompute); each run's step ms, peak bytes, and the
   card's allocated bytes at its first step beside ``sharded_bytes`` of
   the placed state; the two runs' losses and checkpoint files (every
   parameter and moment) equal bit for bit.  Then one dry-run record
   (``launch.dryrun.run_cell``: qwen3-0.6b train_4k on the 16 x 16 mesh,
   traced on meta tensors) and the three LM examples
   (``examples/*_torch.py``) on the card, each in its own process, the
   three side by side.
17. the kernels line (the lane kernel's and the fold's entries count
   ``paper_demo``'s example's launches too; the closed form's entry
   counts its launches by phase: the ``closed_form`` queries, GENESIS's
   pricing and its DNN's ``estimate_energy``, and ``paper_demo``'s
   example, peak run and matrix, each zeroed just before and read just
   after; the flash and SSD entries
   these phases': ``moe_launches``, ``vlm_launches``, ``train_launches``,
   ``hybrid_launches``, ``encdec_launches`` and ``lm_mesh_launches``, the
   last three also by kernel, with each kernel's time at the hybrid and
   encdec phases' shapes), the ``nvidia-smi`` line, and the result
   line.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): FP64 outside the tensor cores, and
#: HBM3 bandwidth.
PEAK_F64_OPS = 34e12
PEAK_BYTES = 3.35e12

#: A floor on the f64 operations of one event, counted from
#: csrc/charge_replay.cu: the row context (~12), the phase-0 and row-phase
#: scalar arithmetic of charge_once (~60) and the 17-wide class update
#: (at least 4 operations per class).  Every row costs at least one event.
MIN_F64_OPS_PER_EVENT = 12 + 60 + 4 * 17

#: The dependent f64 operations on the shortest path through one event of
#: the main path's runs (each a charge_once: tools/profile_replay.py counts
#: them), from the charge the event starts with to the one the next event
#: starts with, counted from csrc/charge_replay.cu's charge_once: a1 = a0 -
#: d_spend, then the finish test (a1 >= x.e + s.left * c_b) and new_rem =
#: a1 - spend_fin side by side.  Every other operand is off this path.
DEP_F64_OPS_PER_EVENT = 2

#: Lanes of the full-width sweeps; lower them if the time limit forces it.
FULL_LANES = 16384
RADIO_LANES = 4096
HAR_LANES = 4096


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


#: The Hopper kernels (wgmma, fed by TMA) by source: a substring of each
#: kernel's mangled name.
WGMMA_KERNELS = {"dense_matmul": ("matmul_wgmma_kernel",
                                  "matmul_tf32x3_kernel"),
                 "flash_attention": ("flash_wgmma_kernel",),
                 "sparse_fc": ("block_sparse_fc_hopper_kernel",),
                 "ssd_intra": ("ssd_wgmma_kernel",)}


def ptxas_by_kernel(log: str) -> dict:
    """Registers, spill bytes and stack frame of each entry function, from
    nvcc's ``-Xptxas -v`` lines."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", ln)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame", ln)
        if m and name:
            out[name]["stack_frame"] = int(m.group(1))
    return out


def cuobjdump_path():
    """The toolkit's ``cuobjdump``, or None where it is missing."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" \
        / "cuobjdump"
    return str(path) if path.exists() else None


def sass_counts(cuobjdump: str, lib_path) -> dict:
    """The HGMMA (wgmma) and UTMALDG (TMA load) instructions in each
    kernel's SASS in a built library, by mangled name."""
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            out[name] = {"HGMMA": 0, "UTMALDG": 0}
        elif name:
            for op in ("HGMMA", "UTMALDG"):
                if op in ln:
                    out[name][op] += 1
    return out


def random_net(seed: int, classes):
    """A random small network and input, deterministic in ``seed`` (the
    recipe of the tests' ``make_random_net``)."""
    import numpy as np

    Conv2D, DenseFC, MaxPool2D, SimNet, SparseFC = classes
    rng = np.random.default_rng(seed)
    ci, h = 1, int(rng.integers(8, 12))
    co = int(rng.integers(2, 5))
    k = int(rng.integers(2, 4))
    w1 = (rng.normal(size=(co, ci, k, k)) * 0.5).astype(np.float32)
    if rng.random() < 0.5:
        w1 *= (rng.random(w1.shape) < 0.4)
    layers = [Conv2D(w1, rng.normal(size=co).astype(np.float32))]
    oh = h - k + 1
    if oh % 2 == 0 and rng.random() < 0.7:
        layers.append(MaxPool2D(2))
        oh //= 2
    feat = co * oh * oh
    m = int(rng.integers(4, 9))
    layers.append(DenseFC((rng.normal(size=(m, feat)) * 0.2
                           ).astype(np.float32),
                          rng.normal(size=m).astype(np.float32)))
    out = int(rng.integers(3, 6))
    wsp = (rng.normal(size=(out, m)) * (rng.random((out, m)) < 0.4)
           ).astype(np.float32)
    layers.append(SparseFC(wsp, rng.normal(size=out).astype(np.float32),
                           relu=False))
    net = SimNet(layers, input_shape=(ci, h, h), name=f"rand{seed}")
    x = rng.normal(size=(ci, h, h)).astype(np.float32)
    return net, x


class Recorder:
    """Stands in for the kernel wrapper while the entry points run: times
    each launch with CUDA events and keeps its inputs, so the same inputs
    can be replayed through the plain version.  The launch count stays on
    the wrapper itself."""

    def __init__(self, torch, wrapper):
        self.torch, self.wrapper = torch, wrapper
        self.calls = []

    def __call__(self, *args, **kw):
        ev0 = self.torch.cuda.Event(enable_timing=True)
        ev1 = self.torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = self.wrapper(*args, **kw)
        ev1.record()
        self.calls.append(dict(args=args, kw=kw, events=(ev0, ev1),
                               out=out))
        return out


def compare(torch, a: dict, b: dict) -> tuple[bool, float, list]:
    """Bitwise comparison of two replays' output channels (NaN == NaN);
    returns (equal, max abs difference over finite entries, bad channels)."""
    bad, err = [], 0.0
    for k, x in a.items():
        y = b[k]
        if x.dtype == torch.bool:
            same = torch.equal(x, y)
            diff = float((x != y).sum())
        else:
            same = bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())
            fin = torch.isfinite(x) & torch.isfinite(y)
            diff = float((x - y).abs()[fin].max()) if bool(fin.any()) \
                else 0.0
        if not same:
            bad.append(k)
        err = max(err, diff)
    return not bad, err, bad


def lane_slice(args, kw, n: int, shared_rows: bool):
    """The first ``n`` lanes of a captured wrapper call."""
    rows, rest = args[0], args[1:]
    if not shared_rows:
        rows = {k: v[:n] for k, v in rows.items()}
    rest = tuple(a[:n].contiguous() if hasattr(a, "dim") and a.dim() >= 1
                 else a for a in rest)
    kw = dict(kw, conf=kw["conf"][:n].contiguous())
    return (rows,) + rest, kw


def replay_bound_ms(args, kw, out, torch) -> tuple[float, str, dict]:
    """The least time the card could take for one replay: bytes (each
    input read once, each output written once) over HBM bandwidth, and a
    floor on the f64 operations (one event per real row) over the FP64
    peak; the larger bounds it."""
    rows = args[0]
    s_real = args[7]
    n_lanes = int(s_real.shape[0])
    in_bytes = (rows.packed.numel() * 8 if hasattr(rows, "packed")
                else sum(v.numel() * 8 for v in rows.values()))  # f64
    in_bytes += sum(a.numel() * a.element_size() for a in args[1:8])
    in_bytes += kw["conf"].numel() * 8 + kw["radio"].numel() * 8
    out_bytes = sum(v.numel() * v.element_size() for v in out.values())
    events = int(s_real.to(torch.int64).sum())
    ops = events * MIN_F64_OPS_PER_EVENT
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F64_OPS * 1e3
    info = dict(lanes=n_lanes, bytes=in_bytes + out_bytes,
                f64_ops_floor=ops, bytes_ms=t_bytes, ops_ms=t_ops)
    if t_ops >= t_bytes:
        return t_ops, "operations", info
    return t_bytes, "bytes", info


#: H100 SXM peaks for the compute kernels (NVIDIA data sheet): f32 on the
#: CUDA cores and bf16 on the tensor cores.
PEAK_F32_OPS = 67e12
PEAK_BF16_OPS = 989e12
#: TF32 on the tensor cores (dense), the rate of each of 3xTF32's products.
PEAK_TF32_OPS = 494.7e12

#: Inputs of the MNIST phase, and the large shape of each compute kernel
#: (matmul M = K = N; block-sparse FC weight edge and batch; FIR C = L).
MNIST_BATCH = 1024
#: The N at which the narrow matmul kernel is timed against the CUDA-core
#: one (dense_matmul.NARROW_MAX_N comes from this sweep).
NARROW_SWEEP_N = (1, 10, 16, 32, 64)
LARGE_MATMUL = 4096
LARGE_SPARSE, LARGE_SPARSE_BATCH = 4096, 512
LARGE_FIR = 8192

#: The compute kernels: name, module, wrapper, source, the TPU kernel it
#: replaces (file:line of the function that reaches pl.pallas_call).
COMPUTE_KERNELS = (
    ("dense_matmul", "dense_matmul", "matmul",
     "src/repro/kernels/dense_matmul.py:32", "matmul"),
    ("block_sparse_fc", "sparse_fc", "block_sparse_matvec",
     "src/repro/kernels/sparse_fc.py:96", "block_sparse_matvec"),
    ("fir_conv1d", "fir_conv1d", "fir_conv1d",
     "src/repro/kernels/fir_conv1d.py:30", "fir_conv1d"),
)


#: Back-to-back calls between two CUDA events when a kernel (or its
#: library yardstick) is timed: the card's queue stays full, so the host's
#: time in a call (the wrapper's checks, a ctypes call, tensor maps) is
#: not counted as the kernel's.
INNER = 10


def median_ms(torch, fn, reps: int = 5, inner: int = 1) -> float:
    """Median over ``reps`` runs of the time of one ``fn`` call in ms, a
    run being ``inner`` calls back to back between two CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        for _ in range(inner):
            fn()
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1) / inner)
    return sorted(times)[len(times) // 2]


def graph_ms(torch, fn, reps: int = 5, inner: int = INNER) -> float:
    """The device's time for one ``fn`` call with no host time in it:
    ``inner`` calls captured in a CUDA graph, the median over ``reps``
    replays between two CUDA events, per call (after a warm-up call on
    the capturing stream)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(inner):
            fn()
    times = []
    for _ in range(reps):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        graph.replay()
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1) / inner)
    del graph
    return sorted(times)[len(times) // 2]


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """The least time (ms) for ``flops`` operations at ``peak`` and
    ``nbytes`` at HBM bandwidth, and which of the two bounds it."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


#: How a compute kernel's output is held against its plain version's.
TOLERANCES = {
    "bitwise": "equal bit for bit",
    "allclose": "|d| <= 2e-4 + 2e-4 |ref| (tests/test_kernels.py)",
    "k4096": "max |d| <= 1e-5 max |ref|",
    "bf16": "|d| <= 2^-7 |ref| + 2^-12 rms(ref) per element (bf16 "
            "products are exact in f32, so the kernel and the plain version "
            "differ only in the order of an f32 sum before one rounding to "
            "bf16: the rounding may flip by one unit, <= 2^-7 |ref|, and the "
            "reordered f32 sum moves by 2.3e-4 at K = 4096 on unit-normal "
            "inputs, against 2^-12 rms(ref) = 0.016 there; a kernel that "
            "drops one 16-wide k-step of a tile takes 550 times the limit, "
            "tests/test_torch_kernels.py)",
    "tf32x3": "max |kernel - f64| <= 4 max |plain f32 - f64| + 2^-24 "
              "max |f64|, the f64 product computed on the card from the "
              "same operands, beside allclose against the plain version "
              "(3xTF32 splits each operand into two tf32 parts and keeps "
              "three of the four products, each exact in f32, so it stays "
              "near f32; a one-pass TF32 product keeps 11 bits of each "
              "operand and misses the rule by more than 100 times at K = "
              "4096, as does a 3xTF32 one product short, "
              "tests/test_torch_kernels.py)",
    "logits": "max |d| <= 1e-4 max |logit|",
    "ssd_f64": "max |kernel - f64| <= 4 max |plain f32 - f64| + 2^-24 "
               "max |f64| per output (the tf32x3 rule), the f64 cell "
               "computed on the card from the same inputs (ref."
               "ssd_intra_ref in float64), for the wgmma kernel beside the "
               "ssd rule: its products are 3xTF32 (S's with decay * x dt in "
               "three tf32 parts, since a steep decay leaves S a sum of a "
               "few products, where two parts missed the rule), and a "
               "one-pass TF32 product misses this limit by more than 50 "
               "times, tests/test_torch_kernels.py",
    "ssd": "max |d| <= 1e-5 max |ref| per output (f32 sums over N then Q "
           "terms in another order than the plain version's cuBLAS "
           "products grow as sqrt(terms), about 1e-6 of the largest value; "
           "a bound on each element would fail on the entries that cancel "
           "to near 0)",
    "attn_bf16": "|d| <= 2^-7 |ref| + 2^-6 rms(ref's row) per element, "
                 "against the plain version at the kernel's own tiles "
                 "(128 x 128 for the wgmma kernel, 64 x 64 for the "
                 "mma.sync one), which takes the same running maxima and so "
                 "rounds p at the same places: what is left is f32 sums in "
                 "another order, which flip the output's bf16 rounding by "
                 "one unit (<= 2^-7 |ref|) and, rarely, a p's; a row's rms "
                 "scales the limit to that row, since an output row over "
                 "n keys has rms about sqrt(e / n) (random q, k, v)",
    "lm_bf16": "max |d| <= 5e-2 max |logit| (once one rounding differs, "
               "the bf16 roundings of the two forwards part ways layer by "
               "layer: one bf16 unit on 16 embedding entries moves the "
               "logits by 0.8-1.1 % at 2-8 layers of these widths on the "
               "CPU, and the blockwise path at the kernel's own tiles gave "
               "1.31 % on the card, as at 1024-row chunks; the attention "
               "kernel's numerics are held per element above, and a "
               "dropped causal mask, a GQA head map in .repeat order or "
               "keys shifted by one move the logits by more than 100 %)",
    "lm_f32": "max |d| <= 1e-4 max |logit| (f32 sums in another order)",
    "ssm_decode_bf16": "max |d| <= 0.1 max |logit| over the positions "
                       "decoded, decode against forward in bf16: the "
                       "recurrent and the chunked forms round at other "
                       "points (the conv's sum, the Dskip add, decode's "
                       "bf16 logits), and the roundings part ways layer by "
                       "layer: on the CPU at mamba2-370m's widths, 2 to 12 "
                       "layers gave 1.2 to 3.6 % growing as sqrt(layers), "
                       "about 7 % at 48; a dropped conv window gives 138 % "
                       "at 8 layers.  With the init recipe the SSD's output "
                       "is 2e-6 of the logits, so this rule holds the conv, "
                       "gate, norms and projections of the recurrent form; "
                       "the f32 rule below, on live weights, the SSD",
    "ssm_decode_f32": "max |d| <= 1e-3 max |logit|, decode against forward "
                      "in f32 on the weights widened and made live "
                      "(live_ssd: conv taps x 50, dt_bias 0, after which "
                      "zeroing the SSD's output moves the logits by 159 % "
                      "at 8 layers on the CPU): f32 sums in another order, "
                      "2.1e-5 to 5.7e-5 at 8 to 24 layers on the CPU, "
                      "growing with depth; a decay or Dskip 10 % off in "
                      "decode moves them by 39 and 51 % at 8 layers",
}

#: The rules of TOLERANCES that bound max |d| by a share of max |ref|.
SCALE_LIMITS = {"k4096": 1e-5, "logits": 1e-4, "ssd": 1e-5, "lm_bf16": 5e-2,
                "lm_f32": 1e-4, "ssm_decode_bf16": 0.1,
                "ssm_decode_f32": 1e-3}


def attn_limit(torch, want):
    """The ``attn_bf16`` limit of each element of ``want`` (f32)."""
    rms = want.square().mean(-1, keepdim=True).sqrt()
    return 2.0 ** -7 * want.abs() + 2.0 ** -6 * rms


def bf16_limit(torch, want):
    """The ``bf16`` (matmul) limit of each element of ``want`` (f32)."""
    return 2.0 ** -7 * want.abs() + 2.0 ** -12 * want.square().mean().sqrt()


def limit_share(torch, got, want, rule: str) -> float:
    """The largest share of its element's limit that a difference takes,
    under the per-element rule ``rule`` (``bf16`` or ``attn_bf16``)."""
    w = want.float()
    limit = (bf16_limit if rule == "bf16" else attn_limit)(torch, w)
    return float(((got.float() - w).abs() / limit).max()) if w.numel() \
        else 0.0


def allclose_share(torch, got, want) -> float:
    """The largest share of its element's ``allclose`` limit that a
    difference takes."""
    w = want.float()
    limit = 2e-4 + 2e-4 * w.abs()
    return float(((got.float() - w).abs() / limit).max()) if w.numel() \
        else 0.0


def tf32x3_share(torch, got, plain, exact) -> float:
    """max |got - exact| as a share of the ``tf32x3`` rule's limit, 4 max
    |plain - exact| + 2^-24 max |exact| (``exact`` in f64)."""
    limit = 4 * float((plain.double() - exact).abs().max()) \
        + 2.0 ** -24 * float(exact.abs().max())
    return float((got.double() - exact).abs().max()) / limit


def agree(torch, got, want, rule: str) -> tuple[bool, float]:
    """Whether ``got`` holds against ``want`` under ``rule`` (a key of
    :data:`TOLERANCES`), and their max abs difference."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False, float("inf")
    g, w = got.float(), want.float()
    if not g.numel():
        return True, 0.0
    d = (g - w).abs()
    diff, scale = float(d.max()), float(w.abs().max())
    if not bool(torch.isfinite(g).all()):
        return False, diff
    if rule == "bitwise":
        return torch.equal(got, want), diff
    if rule == "allclose":
        return bool((d <= 2e-4 + 2e-4 * w.abs()).all()), diff
    if rule == "attn_bf16":
        return bool((d <= attn_limit(torch, w)).all()), diff
    if rule == "bf16":
        return bool((d <= bf16_limit(torch, w)).all()), diff
    return diff <= SCALE_LIMITS[rule] * scale, diff


def scale_share(torch, got, want, rule: str) -> float:
    """max |got - want| as a share of the limit of a rule of
    :data:`SCALE_LIMITS`."""
    return float((got - want).abs().max()) / (
        SCALE_LIMITS[rule] * float(want.abs().max()))


def conv_by_fir(torch, fir, x, w, b):
    """A valid 2-D convolution composed from FIRs as TAILS does (Sec. 7.2):
    one FIR per (ci, dy) over all B * co * ho rows stacked as channels,
    summed in plain PyTorch; then bias and ReLU."""
    bsz, ci, h, wd = x.shape
    co, _, kh, kw = w.shape
    ho, wo = h - kh + 1, wd - kw + 1
    out = torch.zeros((bsz, co, ho, wo), device=x.device)
    for c in range(ci):
        for dy in range(kh):
            rows = x[:, None, c, dy:dy + ho, :].expand(
                bsz, co, ho, wd).reshape(-1, wd).contiguous()
            taps = w[None, :, c, dy, None, :].expand(
                bsz, co, ho, kw).reshape(-1, kw).contiguous()
            out += fir(rows, taps).reshape(bsz, co, ho, wo)
    return torch.relu(out + b.view(1, co, 1, 1))


def pool2(h):
    b, c, hh, ww = h.shape
    return h.reshape(b, c, hh // 2, 2, ww // 2, 2).amax(dim=(3, 5))


def mnist_chain(torch, params, x, fir, sfc, mm):
    """``mnist_net()`` over a batch: convs from FIRs, fc1 block-sparse,
    fc2 and fc3 dense; bias, ReLU and pooling in plain PyTorch."""
    c1w, c1b, c2w, c2b, b1, w2t, b2, w3t, b3 = params
    h = pool2(conv_by_fir(torch, fir, x, c1w, c1b))
    h = pool2(conv_by_fir(torch, fir, h, c2w, c2b))
    h = h.reshape(h.shape[0], -1)
    h = torch.relu(sfc(h) + b1)
    h = torch.relu(mm(h, w2t) + b2)
    return mm(h, w3t) + b3


def checkerboard(np, rng, n: int, blk: int):
    """An (n, n) f32 weight with every other (blk, blk) block zero."""
    w = rng.normal(size=(n, n)).astype(np.float32)
    for i in range(n // blk):
        for j in range(n // blk):
            if (i + j) % 2:
                w[i * blk:(i + 1) * blk, j * blk:(j + 1) * blk] = 0
    return w


def compute_kernels(torch, np, emit, hopper) -> list[dict]:
    """Phases 6 and 7: the three compute kernels against their plain
    versions at small shapes, then at full width with their launches
    counted; returns their entries of the kernels line."""
    import importlib

    import torch.nn.functional as F

    from repro_torch.compress.prune import prune_by_sparsity
    from repro_torch.core.inference import SimNet, SparseFC
    from repro_torch.kernels import (BlockSparseFC, MatmulTiles,
                                     dense_matmul, fir_conv1d, fir_tiles,
                                     matmul_tiles, ref)
    from repro_torch.models.dnn import mnist_net

    mods = {name: importlib.import_module(f"repro_torch.kernels.{mod}")
            for name, mod, *_ in COMPUTE_KERNELS}
    wrappers = {name: getattr(mods[name], fn)
                for name, _m, fn, *_ in COMPUTE_KERNELS}
    sparse_plain = mods["block_sparse_fc"].block_sparse_matvec_plain
    f32, bf16 = torch.float32, torch.bfloat16

    def dev(a, dtype=f32):
        a = np.ascontiguousarray(a, np.float32)
        return torch.from_numpy(a).to(dtype).cuda()

    def fc_plain(fc):
        return lambda h: sparse_plain(h, *fc._bundle, fc.m, bm=fc.bm,
                                      bk=fc.bk)

    def fc_exact(fc, h):
        """h @ W^T in f64 from the layer's own bundle (the tf32x3 rule's
        reference)."""
        vals, row_ptr, col_idx = fc._bundle
        nbr = row_ptr.numel() - 1
        nbc = fc.padded_k // fc.bk
        rows = torch.repeat_interleave(
            torch.arange(nbr, device=vals.device), torch.diff(row_ptr.long()))
        w = torch.zeros((nbr, nbc, fc.bm, fc.bk), dtype=torch.float64,
                        device=vals.device)
        w.index_put_((rows, col_idx.long()), vals.double(), accumulate=True)
        w = w.permute(0, 2, 1, 3).reshape(nbr * fc.bm, nbc * fc.bk)
        return h.double() @ w[:fc.m, :fc.k].T

    # ---- 6. every compute kernel against its plain version, small shapes
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    # (kernel, case, kernel output, plain output, rule, the kernel's path)
    checks = []
    # f32 outputs under the tf32x3 rule: (kernel, case, path, kernel
    # output, plain, f64 product)
    tf32_checks = []
    for m, k, n, dtype, tiles, want_path in (
            # N up to 64 that no tensor-core kernel takes: the narrow
            # kernel (ragged M and K, N = 1, 3, 17, 31, 64, bf16); wider
            # N on the CUDA cores
            (13, 57, 31, f32, None, "narrow"), (1, 1, 1, f32, None, "narrow"),
            (1000, 333, 10, f32, None, "narrow"),
            (300, 70, 17, f32, None, "narrow"),
            (1025, 5, 3, f32, None, "narrow"),
            (2, 700, 1, f32, None, "narrow"),
            (129, 1000, 70, f32, None, "simt"),
            # f32 that TMA reads: explicit tiles (the CUDA-core kernel's,
            # run on it too below); ragged M, N and K (a K tail of 12);
            # K = 4; K split 2 ways (one slice each, and 3 + 2) and 4
            (64, 512, 384, f32, (8, 128, 128), "tf32x3"),
            (64, 512, 384, f32, (16, 256, 128), "tf32x3"),
            (200, 300, 100, f32, None, "tf32x3"),
            (13, 4, 36, f32, None, "tf32x3"),
            (64, 60, 64, f32, None, "tf32x3"),
            (512, 160, 768, f32, None, "tf32x3"),
            (128, 1024, 256, f32, None, "tf32x3"),
            # bf16: aligned; ragged M, N and K with aligned strides (a K
            # tail of 40, then of 8); unaligned strides on the CUDA cores
            (128, 256, 192, bf16, None, "wgmma"),
            (200, 296, 104, bf16, None, "wgmma"),
            (64, 520, 136, bf16, None, "wgmma"),
            (13, 57, 31, bf16, None, "narrow"),
            (1, 1, 1, bf16, None, "narrow"),
            (77, 130, 64, bf16, None, "narrow"),
            (200, 300, 100, bf16, None, "simt")):
        x = dev(rng.normal(size=(m, k)), dtype)
        w = dev(rng.normal(size=(k, n)), dtype)
        path = mods["dense_matmul"].matmul_path(x, w)
        if path != want_path:
            raise SystemExit(f"kernels_vs_plain: dense_matmul {m}x{k}x{n} "
                             f"{dtype} takes the {path} kernel, not the "
                             f"{want_path} one")
        t = tiles and MatmulTiles(*tiles)
        case = f"{m}x{k}x{n} {str(dtype)[6:]} tiles={tiles}"
        got, want = dense_matmul(x, w, tiles=t), ref.matmul_ref(x, w)
        runs_ = [(path, got)]
        if path == "narrow":
            # the CUDA-core kernel sums each output in the same order
            simt = mods["dense_matmul"].launch(x, w, "simt")
            if not torch.equal(got, simt):
                raise SystemExit(f"kernels_vs_plain: dense_matmul {case} "
                                 f"(narrow) differs from the CUDA-core "
                                 f"kernel")
            case += " bitwise_vs_simt=True"
        if path == "tf32x3":
            case += f" split={mods['dense_matmul'].tf32x3_plan(m, k, n).split}"
            if not torch.equal(dense_matmul(x, w, tiles=t), got):
                raise SystemExit(f"kernels_vs_plain: dense_matmul {case} "
                                 f"(tf32x3) differs from run to run")
            if tiles:
                # the CUDA-core kernel at these tiles, on the same operands
                runs_.append(("simt", mods["dense_matmul"].launch(
                    x, w, "simt", bm=tiles[0], bk=tiles[1], bn=tiles[2])))
        for p, out in runs_:
            checks.append(("dense_matmul", case, out, want,
                           "allclose" if dtype == f32 else "bf16", p))
            if p == "tf32x3":
                tf32_checks.append(("dense_matmul", case, p, out, want,
                                    x.double() @ w.double()))
    # dense_matmul on a mixed pair: widened, the f32 kernel, x's dtype
    for xdt, wdt in ((f32, bf16), (bf16, f32)):
        x = dev(rng.normal(size=(200, 296)), xdt)
        w = dev(rng.normal(size=(296, 104)), wdt)
        path = mods["dense_matmul"].matmul_path(x.float(), w.float())
        if path != "tf32x3":
            raise SystemExit(f"kernels_vs_plain: dense_matmul on a mixed "
                             f"pair takes the {path} kernel, not tf32x3")
        case = f"200x296x104 {str(xdt)[6:]} x {str(wdt)[6:]}"
        got, want = dense_matmul(x, w), ref.matmul_ref(x, w)
        checks.append(("dense_matmul", case, got, want,
                       "allclose" if xdt == f32 else "bf16", path))
        if xdt == f32:
            tf32_checks.append(("dense_matmul", case, path, got, want,
                                x.double() @ w.double()))
    w_empty = rng.normal(size=(512, 512)).astype(np.float32)
    w_empty[128:, :] = 0
    w_empty[:128, 256:] = 0
    w_ragged = rng.normal(size=(300, 200)).astype(np.float32)
    w_ragged[:, 60:] *= rng.random((300, 140)) < 0.05
    w_ragged[128:256] = 0
    smod = mods["block_sparse_fc"]
    for w, batch, blocks in ((w_empty, 8, (128, 128, 8)),
                             (w_ragged, 1, (128, 128, 8)),
                             (w_ragged, 7, (128, 128, 8)),
                             (w_ragged, 17, (128, 128, 8)),
                             (w_ragged, 33, (128, 128, 32)),
                             (w_ragged, 129, (128, 128, 8)),
                             (w_ragged, 200, (128, 64, 8)),
                             (w_ragged, 9, (64, 48, 4)),
                             (w_ragged, 5, (40, 40, 1))):
        bm, bk, bn = blocks
        fc = BlockSparseFC(w, bm=bm, bk=bk, bn=bn)
        if w is w_empty and fc.vals.shape[0] != 5:
            raise SystemExit("kernels_vs_plain: the empty-row-block bundle "
                             f"holds {fc.vals.shape[0]} blocks, not 5")
        # the same bundle with bf16 values, given to the layer as a tensor
        fc16 = BlockSparseFC.from_block_csr(
            torch.from_numpy(fc.vals).to(bf16), fc.row_ptr, fc.col_idx,
            fc.m, fc.k, bm, bk, bn)
        tensor_cores = bm == 128 and bk % 64 == 0
        for xdt, layer in ((f32, fc), (bf16, fc16), (bf16, fc), (f32, fc16)):
            if xdt != layer._bundle[0].dtype and batch != 17:
                continue                   # the mixed pairs: one batch
            x = dev(rng.normal(size=(batch, w.shape[1])), xdt)
            want_path = "simt" if not tensor_cores else \
                "wgmma" if xdt == layer._bundle[0].dtype == bf16 \
                else "tf32x3"
            path = smod.fc_path(x, layer._bundle[0], bm, bk)
            case = (f"{w.shape} nnzb={fc.vals.shape[0]} batch={batch} "
                    f"blocks={blocks} x {str(xdt)[6:]} vals "
                    f"{str(layer._bundle[0].dtype)[6:]}")
            if path != want_path:
                raise SystemExit(f"kernels_vs_plain: block_sparse_fc {case} "
                                 f"takes the {path} kernel, not the "
                                 f"{want_path} one")
            want = fc_plain(layer)(x)
            runs_ = [(path, layer(x))]
            if path == "tf32x3" and xdt == layer._bundle[0].dtype:
                # the CUDA-core kernel it replaced, on the same operands
                runs_.append(("simt", smod.launch(
                    x, *layer._bundle, layer.m, "simt", bm=bm, bk=bk,
                    bn=bn)))
            for p, got in runs_:
                checks.append(("block_sparse_fc", case, got, want,
                               "allclose" if xdt == f32 else "bf16", p))
                if p == "tf32x3":      # the rule is 3xTF32's, not simt's
                    tf32_checks.append(("block_sparse_fc", case, p, got,
                                        want, fc_exact(layer, x)))
    # the FIR: the tests' shapes, L = 1, K = L, tiles that end mid-row
    # with spans off 16-byte boundaries (999 x 13, 3000 x 12, 700 x 28, and
    # 40000 x 12 and 20000 x 28, enough tiles for the entry point to take
    # the flat kernel), the largest K of the flat design at L = 300 and the
    # next, x off a 16-byte boundary; every dtype pair.  Each through the
    # entry point, bitwise; the other design by name where it takes the
    # operands, bitwise too.
    fmod = mods["fir_conv1d"]
    for c, length, k, off in (
            (37, 101, 7, False), (5, 12, 1, False), (5, 12, 12, False),
            (1, 1, 1, False), (3, 300, 70, False), (2, 600, 33, False),
            (4000, 28, 5, False), (999, 13, 5, False), (3000, 12, 5, False),
            (700, 28, 5, False), (40000, 12, 5, False),
            (20000, 28, 5, False), (3, 300, 117, False), (3, 300, 118, False),
            (2, 300, 300, False), (700, 28, 5, True)):
        for xdt, tdt in ((f32, f32), (bf16, bf16), (f32, bf16),
                         (bf16, f32)):
            x = dev(rng.normal(size=(c, length)), xdt)
            if off:
                x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(
                    c, length)
            taps = dev(rng.normal(size=(c, k)), tdt)
            case = (f"C={c} L={length} K={k} x {str(xdt)[6:]} taps "
                    f"{str(tdt)[6:]}" + (" x 4 bytes off" if off else ""))
            path = fmod.fir_path(x, taps)
            if (length, k) in ((12, 5), (28, 5)) and xdt == tdt \
                    and fmod.flat_takes(x, taps) == off:
                raise SystemExit(f"kernels_vs_plain: the flat FIR kernel "
                                 f"{'takes' if off else 'does not take'} "
                                 f"{case}")
            want = ref.fir_conv1d_ref(x, taps)
            checks.append(("fir_conv1d", case, fir_conv1d(x, taps), want,
                           "bitwise", path))
            if path == "flat":
                checks.append(("fir_conv1d", case, fmod.launch(
                    x, taps, "tiled", cb=fir_tiles(c, length,
                                                   x.element_size())),
                    want, "bitwise", "tiled"))
            elif fmod.flat_takes(x, taps):
                checks.append(("fir_conv1d", case,
                               fmod.launch(x, taps, "flat"), want,
                               "bitwise", "flat"))
    torch.cuda.synchronize()
    small_err = {}
    for name, case, got, want, rule, path in checks:
        ok, diff = agree(torch, got, want, rule)
        small_err[name] = max(small_err.get(name, 0.0), diff)
        if not ok:
            raise SystemExit(f"kernels_vs_plain: {name} {case} ({path}): "
                             f"kernel disagrees with the plain version "
                             f"({TOLERANCES[rule]}; max abs diff {diff})")
        if path is not None:
            line = {"phase": "kernels_vs_plain", "kernel": name,
                    "case": case, "path": path, "max_abs_diff_vs_plain": diff,
                    "rule": rule}
            if rule != "bitwise":
                line["limit_share"] = limit_share(torch, got, want, rule) \
                    if rule == "bf16" else allclose_share(torch, got, want)
            emit(line)
    tf32_share = 0.0
    for name, case, path, got, want, exact in tf32_checks:
        share = tf32x3_share(torch, got, want, exact)
        tf32_share = max(tf32_share, share)
        emit({"phase": "kernels_vs_plain", "kernel": name,
              "case": case, "path": path, "rule": "tf32x3",
              "limit_share": share})
        if share > 1.0:
            raise SystemExit(f"kernels_vs_plain: {name} {case} "
                             f"({path}) misses the tf32x3 rule "
                             f"({TOLERANCES['tf32x3']}; {share} of the "
                             f"limit)")
    emit({"phase": "kernels_vs_plain", "cases": len(checks),
          "max_abs_diff_vs_plain": small_err, "all_agree": True,
          "tf32x3_max_limit_share": tf32_share,
          "tolerances": {"f32 outputs": [TOLERANCES["allclose"],
                                         TOLERANCES["tf32x3"]],
                         "bf16 outputs": TOLERANCES["bf16"],
                         "fir_conv1d": TOLERANCES["bitwise"]},
          "seconds": time.perf_counter() - t0})
    del checks, tf32_checks

    # ---- 7. the entry points at full width, launches counted
    rng = np.random.default_rng(0)
    runs = []

    def run(kernel, shape, out, kernel_fn, plain_fn, library_fn, flops,
            nbytes, peak, rule, headline, entry=None, previous_fn=None,
            path=None, exact_fn=None, hopper_source=None, bounds=None,
            plan=None, flat_fn=None, looped_fn=None):
        runs.append(dict(kernel=kernel, shape=shape, out=out,
                         kernel_fn=kernel_fn, plain_fn=plain_fn,
                         library_fn=library_fn, flops=flops, bytes=nbytes,
                         peak=peak, rule=rule, headline=headline,
                         entry=entry or kernel, previous_fn=previous_fn,
                         path=path, exact_fn=exact_fn,
                         hopper_source=hopper_source, bounds=bounds,
                         plan=plan, flat_fn=flat_fn, looped_fn=looped_fn))

    mmod = mods["dense_matmul"]

    def matmul_run(m, k, n, dtype, rule, want_path, headline=False):
        """One product through the entry point; one that a tensor-core
        kernel takes is also timed on the CUDA-core kernel it replaced, at
        the tiles the entry point gives that kernel."""
        x = dev(rng.normal(size=(m, k)), dtype)
        w = dev(rng.normal(size=(k, n)), dtype)
        size = x.element_size()
        path = mmod.matmul_path(x, w)
        if path != want_path:
            raise SystemExit(f"kernels_full_width: dense_matmul {m}x{k}x{n} "
                             f"{dtype} takes the {path} kernel, not the "
                             f"{want_path} one")
        t = matmul_tiles(m, k, n, size)
        previous = None if path == "simt" else (
            lambda: mmod.launch(x, w, "simt", bm=t.bm, bk=t.bk, bn=t.bn))
        flops = 2.0 * m * n * k
        bounds = plan = None
        if path == "tf32x3":   # three tf32 products, or f32 on CUDA cores
            bounds = {"tf32x3_tensor_cores_ms": 3 * flops / PEAK_TF32_OPS
                      * 1e3, "cuda_cores_ms": flops / PEAK_F32_OPS * 1e3}
            p = mmod.tf32x3_plan(m, k, n)
            plan = dict(p._asdict(), ctas=p.ctas(m, n))
        if path == "narrow":
            p = mmod.narrow_plan(m, k, n, size)
            plan = dict(p._asdict(), ctas=-(-m // p.bm))
            if not torch.equal(dense_matmul(x, w), previous()):
                raise SystemExit(f"kernels_full_width: dense_matmul "
                                 f"{m}x{k}x{n} (narrow) differs from the "
                                 f"CUDA-core kernel")
        run("dense_matmul", f"{m}x{k}x{n} {str(dtype)[6:]}",
            dense_matmul(x, w), lambda: dense_matmul(x, w),
            lambda: ref.matmul_ref(x, w), lambda: torch.matmul(x, w),
            3 * flops if path == "tf32x3" else flops,
            size * (m * k + k * n + m * n),
            {"simt": PEAK_F32_OPS, "narrow": PEAK_F32_OPS,
             "tf32x3": PEAK_TF32_OPS, "wgmma": PEAK_BF16_OPS}[path], rule,
            headline,
            entry=None if path == "simt" else f"dense_matmul_{path}",
            previous_fn=previous, path=path,
            exact_fn=(lambda: x.double() @ w.double())
            if path == "tf32x3" else None,
            hopper_source=None if path in ("simt", "narrow")
            else "dense_matmul",
            bounds=bounds, plan=plan)

    smod = mods["block_sparse_fc"]

    def sparse_run(w, batch, dtype, rule, want_path, headline=False):
        """The layer on the dense-with-zeros weight ``w`` (bf16 values
        given as a tensor) over ``batch`` inputs of ``dtype``; timed beside
        the CUDA-core kernel it replaced and a dense ``torch.matmul`` of
        the same dtype."""
        fc = BlockSparseFC(w)
        if dtype == bf16:
            fc = BlockSparseFC.from_block_csr(
                torch.from_numpy(fc.vals).to(bf16), fc.row_ptr, fc.col_idx,
                fc.m, fc.k, fc.bm, fc.bk, fc.bn)
        x = dev(rng.normal(size=(batch, w.shape[1])), dtype)
        wd = dev(w, dtype)
        path = smod.fc_path(x, fc._bundle[0], fc.bm, fc.bk)
        if path != want_path:
            raise SystemExit(f"kernels_full_width: block_sparse_fc "
                             f"{w.shape} {dtype} takes the {path} kernel, "
                             f"not the {want_path} one")
        nnzb = fc.vals.shape[0]
        size = x.element_size()
        flops = 2.0 * batch * nnzb * fc.bm * fc.bk
        bounds = None
        if path == "tf32x3":   # three tf32 products, or f32 on CUDA cores
            bounds = {"tf32x3_tensor_cores_ms": 3 * flops / PEAK_TF32_OPS
                      * 1e3, "cuda_cores_ms": flops / PEAK_F32_OPS * 1e3}
        run("block_sparse_fc",
            f"{w.shape[0]}x{w.shape[1]} density {fc.density:.2f} "
            f"batch {batch} {str(dtype)[6:]}", fc(x), lambda: fc(x),
            lambda: fc_plain(fc)(x), lambda: torch.matmul(x, wd.T),
            3 * flops if path == "tf32x3" else flops,
            size * (x.numel() + fc._bundle[0].numel() + batch * fc.m)
            + 4 * (fc.row_ptr.size + fc.col_idx.size),
            PEAK_TF32_OPS if path == "tf32x3" else PEAK_BF16_OPS
            if path == "wgmma" else PEAK_F32_OPS, rule, headline,
            entry="block_sparse_fc_wgmma" if path == "wgmma" else None,
            previous_fn=lambda: smod.launch(x, *fc._bundle, fc.m, "simt",
                                            bm=fc.bm, bk=fc.bk, bn=fc.bn),
            path=path, exact_fn=(lambda: fc_exact(fc, x))
            if dtype == f32 else None, hopper_source="sparse_fc",
            bounds=bounds)

    def fir_run(c, length, k, dtype=f32, headline=False, name=None,
                want_path="flat"):
        """The FIR through the entry point, ``F.conv1d`` with groups = C as
        the library call; on the flat kernel, timed beside the tiled one
        it replaced at the tiles ``fir_tiles`` gives it (``previous_ms``)
        and, at K = 5, beside its own instantiation that loops over K
        (``looped_ms``: what the unrolled K = 5 one saves); on the tiled
        one, beside the flat one by name (``flat_ms``)."""
        x = dev(rng.normal(size=(c, length)), dtype)
        taps = dev(rng.normal(size=(c, k)), dtype)
        n_out = length - k + 1
        path = fmod.fir_path(x, taps)
        if path != want_path:
            raise SystemExit(f"kernels_full_width: fir_conv1d C={c} "
                             f"L={length} K={k} takes the {path} kernel, "
                             f"not the {want_path} one")
        cb = fir_tiles(c, length, x.element_size())
        run("fir_conv1d", (name + ": " if name else "")
            + f"C={c} L={length} K={k} {str(dtype)[6:]}",
            fir_conv1d(x, taps), lambda: fir_conv1d(x, taps),
            lambda: ref.fir_conv1d_ref(x, taps),
            lambda: F.conv1d(x[None], taps[:, None], groups=c),
            2.0 * c * n_out * k,
            x.element_size() * (c * length + c * k + c * n_out),
            PEAK_F32_OPS, "bitwise", headline,
            previous_fn=(lambda: fmod.launch(x, taps, "tiled", cb=cb))
            if path == "flat" else None, path=path,
            flat_fn=(lambda: fmod.launch(x, taps, "flat"))
            if path == "tiled" and fmod.flat_takes(x, taps) else None,
            looped_fn=(lambda: fmod.launch(x, taps, "flat", looped=True))
            if path == "flat" and k == 5 else None)

    net = mnist_net()
    conv1, _p1, conv2, _p2, fc1, fc2, fc3 = net.layers
    w1p = prune_by_sparsity(fc1.w, 0.9)
    xs = np.random.default_rng(42).normal(
        size=(MNIST_BATCH,) + net.input_shape).astype(np.float32)
    params = [dev(a) for a in (conv1.w, conv1.b, conv2.w, conv2.b, fc1.b,
                               fc2.w.T, fc2.b, fc3.w.T, fc3.b)]
    x_mnist = dev(xs)
    sfc = BlockSparseFC(w1p)

    for name in wrappers:
        wrappers[name].launches = 0     # zero just before the path
    by_path = wrappers["dense_matmul"].launches_by_path
    sparse_by_path = wrappers["block_sparse_fc"].launches_by_path
    fir_by_path = wrappers["fir_conv1d"].launches_by_path
    for counts in (by_path, sparse_by_path, fir_by_path):
        for p in counts:
            counts[p] = 0
    t0 = time.perf_counter()
    # the repo's benchmark shapes (benchmarks/kernels_bench.py)
    matmul_run(512, 1024, 768, f32, "allclose", "tf32x3")
    sparse_run(checkerboard(np, rng, 512, 128), 16, f32, "allclose",
               "tf32x3")
    fir_run(128, 512, 5, want_path="tiled")   # 32 tiles: fewer than SMs
    bench_launches = {n: w.launches for n, w in wrappers.items()}
    tf32x3_before = sparse_by_path["tf32x3"]
    matmul_before = dict(by_path)
    fir_before = dict(fir_by_path)
    # MNIST at its published widths over a batch
    logits = mnist_chain(torch, params, x_mnist, fir_conv1d, sfc,
                         dense_matmul)
    torch.cuda.synchronize()
    mnist_launches = {n: w.launches - bench_launches[n]
                      for n, w in wrappers.items()}
    mnist_fir_by_path = {p: fir_by_path[p] - fir_before[p]
                         for p in fir_by_path}
    if mnist_fir_by_path != {"flat": mnist_launches["fir_conv1d"],
                             "tiled": 0} or not mnist_fir_by_path["flat"]:
        raise SystemExit(f"kernels_full_width: MNIST's FIR launches went "
                         f"{mnist_fir_by_path}, not all to the flat kernel")
    if sparse_by_path["tf32x3"] != tf32x3_before + 1:
        raise SystemExit("kernels_full_width: MNIST's fc1 did not go "
                         "through the tf32x3 kernel")
    if {p: by_path[p] - matmul_before[p] for p in by_path} != \
            {"wgmma": 0, "tf32x3": 1, "narrow": 1, "simt": 0}:
        raise SystemExit("kernels_full_width: MNIST's fc2 did not go "
                         "through the tf32x3 matmul kernel, or fc3 (N = "
                         "10) not through the narrow one")
    # the FIR at MNIST's two convolutions as conv_by_fir stacks them: 1024
    # inputs x 20 channels x 24 rows of 28 (conv1), x 100 x 8 rows of 12
    # (conv2)
    fir_run(MNIST_BATCH * 20 * 24, 28, 5, name="MNIST conv1")
    fir_run(MNIST_BATCH * 100 * 8, 12, 5, name="MNIST conv2")
    # the narrow kernel at MNIST's fc3 shape, where the main path runs it
    matmul_run(MNIST_BATCH, fc3.w.shape[1], fc3.w.shape[0], f32, "allclose",
               "narrow", headline=True)
    # one large shape per kernel
    n = LARGE_MATMUL
    matmul_run(n, n, n, f32, "k4096", "tf32x3", headline=True)
    matmul_run(n, n, n, bf16, "bf16", "wgmma", headline=True)
    w_large = checkerboard(np, rng, LARGE_SPARSE, 128)
    sparse_run(w_large, LARGE_SPARSE_BATCH, f32, "k4096", "tf32x3",
               headline=True)
    sparse_run(w_large, LARGE_SPARSE_BATCH, bf16, "bf16", "wgmma",
               headline=True)
    del w_large
    fir_run(LARGE_FIR, LARGE_FIR, 5, headline=True)
    fir_run(LARGE_FIR, LARGE_FIR, 5, dtype=bf16)
    fir_launches_by_path = dict(fir_by_path)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}   # read just after
    matmul_by_path = dict(by_path)
    fc_by_path = dict(sparse_by_path)
    path_s = time.perf_counter() - t0
    for name, n in launches.items():
        if n <= 0:
            raise SystemExit(f"kernels_full_width: {name} never launched")
    for path, n in matmul_by_path.items():
        if n <= 0 and path != "simt":   # no main-path call takes simt now
            raise SystemExit(f"kernels_full_width: the {path} matmul kernel "
                             f"never launched")
    for path in ("tf32x3", "wgmma"):
        if fc_by_path[path] <= 0:
            raise SystemExit(f"kernels_full_width: the {path} block-sparse "
                             f"kernel never launched")

    # the MNIST logits: against the plain chain on the card (all inputs)
    # and against the numpy simulator (first 8 inputs)
    t0 = time.perf_counter()
    mnist_chain(torch, params, x_mnist, fir_conv1d, sfc, dense_matmul)
    torch.cuda.synchronize()
    kernel_chain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain_logits = mnist_chain(torch, params, x_mnist, ref.fir_conv1d_ref,
                               fc_plain(sfc), ref.matmul_ref)
    torch.cuda.synchronize()
    plain_chain_s = time.perf_counter() - t0
    ok, diff_plain = agree(torch, logits, plain_logits, "logits")
    if not ok or logits.shape != (MNIST_BATCH, 10):
        raise SystemExit(f"mnist: logits disagree with the plain chain "
                         f"(max abs diff {diff_plain})")
    ref_net = SimNet([conv1, _p1, conv2, _p2, SparseFC(w1p, fc1.b), fc2,
                      fc3], input_shape=net.input_shape, name="mnist-fc1-90")
    want = torch.tensor(np.stack([ref_net.ref_forward(xs[i])
                                  for i in range(8)]).astype(np.float32))
    ok, diff_ref = agree(torch, logits[:8].cpu(), want, "logits")
    if not ok:
        raise SystemExit(f"mnist: logits disagree with SimNet.ref_forward "
                         f"(max abs diff {diff_ref})")
    emit({"phase": "kernels_full_width", "run": "mnist", "batch":
          MNIST_BATCH, "launches": mnist_launches,
          "fc1_block_density": sfc.density,
          "fc1_element_sparsity": float(np.mean(w1p == 0)),
          "kernel_chain_s": kernel_chain_s, "plain_chain_s": plain_chain_s,
          "max_abs_diff_vs_plain": diff_plain,
          "max_abs_diff_vs_ref_forward": diff_ref,
          "max_abs_logit": float(want.abs().max()),
          "tolerance": TOLERANCES["logits"]})

    # every run: against its plain version, then timed
    entries = {}
    mnist_fir = []
    for r in runs:
        plain = r["plain_fn"]()
        torch.cuda.synchronize()
        ok, diff = agree(torch, r["out"], plain, r["rule"])
        if not ok:
            raise SystemExit(f"kernels_full_width: {r['kernel']} "
                             f"{r['shape']} disagrees with the plain version "
                             f"({TOLERANCES[r['rule']]}; max abs diff "
                             f"{diff})")
        if r["path"] == "tf32x3" and not torch.equal(r["kernel_fn"](),
                                                      r["out"]):
            raise SystemExit(f"kernels_full_width: {r['kernel']} "
                             f"{r['shape']} ({r['path']}) differs from run "
                             f"to run")
        share = limit_share(torch, r["out"], plain, "bf16") \
            if r["rule"] == "bf16" else None
        tf32_share = None
        if r["path"] == "tf32x3":
            tf32_share = tf32x3_share(torch, r["out"], plain, r["exact_fn"]())
            if tf32_share > 1.0:
                raise SystemExit(f"kernels_full_width: {r['kernel']} "
                                 f"{r['shape']} misses the tf32x3 rule "
                                 f"({TOLERANCES['tf32x3']}; {tf32_share} "
                                 f"of the limit)")
        del plain
        ms = median_ms(torch, r["kernel_fn"], inner=INNER)
        plain_ms = median_ms(torch, r["plain_fn"], reps=3)
        library_ms = median_ms(torch, r["library_fn"], inner=INNER)
        bound_ms, bound_by = bound(r["flops"], r["bytes"], r["peak"])
        line = {"phase": "kernels_full_width", "kernel": r["kernel"],
                "path": r["path"], "shape": r["shape"], "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "of_bound": bound_ms / ms, "flops": r["flops"],
                "bytes": r["bytes"], "max_abs_diff_vs_plain": diff,
                "tolerance": TOLERANCES[r["rule"]]}
        if share is not None:
            line["limit_share"] = share
        if tf32_share is not None:
            line["tf32x3_limit_share"] = tf32_share
            line["tf32x3_tolerance"] = TOLERANCES["tf32x3"]
        if r["bounds"] is not None:
            line["bounds_ms"] = r["bounds"]
        if r["path"] == "tf32x3":
            line["tf32x3_plan"] = r["plan"]
            line["bitwise_rerun"] = True
        if r["path"] == "narrow":
            line["narrow_plan"] = r["plan"]
            line["bitwise_vs_previous"] = True
        if r["kernel"] == "fir_conv1d":
            # the other design gives the same bits; the device's time of
            # each, from CUDA graphs (these calls are host-bound at the
            # benchmark's shape), is what fir_path's FLAT_MIN_TILES rests on
            other = r["previous_fn"] or r["flat_fn"]
            if other is not None and not torch.equal(other(), r["out"]):
                raise SystemExit(f"kernels_full_width: fir_conv1d "
                                 f"{r['shape']}: the flat kernel differs "
                                 f"from the tiled one")
            line["bitwise_vs_other_design"] = other is not None
            line["graph_ms"] = graph_ms(torch, r["kernel_fn"])
            if r["previous_fn"] is not None:
                line["previous_graph_ms"] = graph_ms(torch, r["previous_fn"])
            if r["flat_fn"] is not None:
                line["flat_ms"] = median_ms(torch, r["flat_fn"], reps=3,
                                            inner=INNER)
                line["flat_graph_ms"] = graph_ms(torch, r["flat_fn"])
            if r["looped_fn"] is not None:
                if not torch.equal(r["looped_fn"](), r["out"]):
                    raise SystemExit(f"kernels_full_width: fir_conv1d "
                                     f"{r['shape']}: the looped flat kernel "
                                     f"differs from the unrolled one")
                line["looped_ms"] = median_ms(torch, r["looped_fn"], reps=3,
                                              inner=INNER)
                line["looped_graph_ms"] = graph_ms(torch, r["looped_fn"])
        if r["previous_fn"] is not None:
            line["previous_ms"] = median_ms(torch, r["previous_fn"], reps=3,
                                            inner=INNER)
        if r["kernel"] == "dense_matmul":
            # the same calls replayed from a CUDA graph: device time alone,
            # for the calls whose host time (checks, tensor maps, a ctypes
            # launch) is longer than their kernel
            line["graph_ms"] = graph_ms(torch, r["kernel_fn"])
            line["library_graph_ms"] = graph_ms(torch, r["library_fn"])
        if r["hopper_source"] is not None:
            line["ptxas_and_sass"] = hopper[r["hopper_source"]]
        emit(line)
        if r["headline"]:
            entries[r["entry"]] = line
        if r["shape"].startswith("MNIST"):
            mnist_fir.append({k: line[k] for k in (
                "shape", "ms", "previous_ms", "graph_ms", "previous_graph_ms",
                "looped_ms", "looped_graph_ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by")})
    emit({"phase": "kernels_full_width", "launches": launches,
          "matmul_launches_by_path": matmul_by_path,
          "block_sparse_fc_launches_by_path": fc_by_path,
          "fir_conv1d_launches_by_path": fir_launches_by_path,
          "mnist_fir_launches_by_path": mnist_fir_by_path,
          "seconds_path": path_s, "all_agree": True})

    # the narrow kernel against the CUDA-core one at MNIST's fc3 M and K
    # and N = 1 .. 64 (named launches, whatever matmul_path says): where
    # it is faster, matmul_path may send N to it (NARROW_MAX_N)
    for n in NARROW_SWEEP_N:
        x = dev(rng.normal(size=(MNIST_BATCH, 500)))
        w = dev(rng.normal(size=(500, n)))
        t = matmul_tiles(MNIST_BATCH, 500, n, 4)
        narrow = lambda: mmod.launch(x, w, "narrow")
        simt = lambda: mmod.launch(x, w, "simt", bm=t.bm, bk=t.bk, bn=t.bn)
        same = torch.equal(narrow(), simt())
        line = {"phase": "narrow_sweep", "shape": f"{MNIST_BATCH}x500x{n} "
                "float32", "path": mmod.matmul_path(x, w),
                "bitwise_vs_simt": same,
                "narrow_ms": median_ms(torch, narrow, inner=INNER),
                "simt_ms": median_ms(torch, simt, inner=INNER),
                "narrow_graph_ms": graph_ms(torch, narrow),
                "simt_graph_ms": graph_ms(torch, simt)}
        emit(line)
        if not same:
            raise SystemExit(f"narrow_sweep: N = {n}: the narrow kernel "
                             f"differs from the CUDA-core one")

    # dense_matmul's main-path kernels are the narrow one (its headline at
    # MNIST's fc3), the wgmma one (bf16) and the 3xTF32 one (f32); the
    # block-sparse FC's are the tensor-core one in 3xTF32 (f32 headline)
    # and in bf16; each with its own launches
    launches["dense_matmul_narrow"] = matmul_by_path["narrow"]
    launches["dense_matmul_wgmma"] = matmul_by_path["wgmma"]
    launches["dense_matmul_tf32x3"] = matmul_by_path["tf32x3"]
    launches["block_sparse_fc"] = fc_by_path["tf32x3"]
    launches["block_sparse_fc_wgmma"] = fc_by_path["wgmma"]
    out = []
    for name, _mod, _fn, replaces, replaces_fn in (
            ("dense_matmul_narrow",) + COMPUTE_KERNELS[0][1:],
            ("dense_matmul_wgmma",) + COMPUTE_KERNELS[0][1:],
            ("dense_matmul_tf32x3",) + COMPUTE_KERNELS[0][1:],
            COMPUTE_KERNELS[1],
            ("block_sparse_fc_wgmma",) + COMPUTE_KERNELS[1][1:],
            COMPUTE_KERNELS[2]):
        e = entries[name]
        src = {"block_sparse_fc": "sparse_fc",
               "block_sparse_fc_wgmma": "sparse_fc"}.get(
                   name, "dense_matmul" if name.startswith("dense_matmul")
                   else name)
        out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": replaces, "replaces_function": replaces_fn,
            "launches": launches[name],
            "max_abs_err": e["max_abs_diff_vs_plain"],
            "max_abs_diff_vs_plain": e["max_abs_diff_vs_plain"],
            "ms": e["ms"], "plain_ms": e["plain_ms"],
            "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
            "library_ms": e["library_ms"], "shape": e["shape"],
            "path": e["path"],
            **({"previous_ms": e["previous_ms"]} if "previous_ms" in e
               else {}),
            **({"bounds_ms": e["bounds_ms"]} if "bounds_ms" in e else {}),
            **({"tf32x3_plan": e["tf32x3_plan"]} if "tf32x3_plan" in e
               else {}),
            **({"narrow_plan": e["narrow_plan"]} if "narrow_plan" in e
               else {}),
            **{k: e[k] for k in ("graph_ms", "library_graph_ms",
                                 "previous_graph_ms", "looped_ms",
                                 "looped_graph_ms") if k in e}})
        if name == "fir_conv1d":
            # the main path's shapes, MNIST's two convolutions, and where
            # its launches went
            out[-1].update(mnist_shapes=mnist_fir,
                           launches_by_path=fir_launches_by_path,
                           mnist_launches_by_path=mnist_fir_by_path)
    return out


#: The LM slice's full-width run: qwen3-0.6b as the repo publishes it, at
#: the sequence length of SHAPES["train_4k"], weights from seed 0 and
#: tokens from seed 42.
LM_ARCH = "qwen3-0.6b"
LM_BATCH, LM_SEQ = 2, 4096
#: The SSD cell at mamba2-370m's widths (Q = ssm_chunk 256, N = ssm_state
#: 128, P = ssm_headdim 64, H = 2 * 1024 / 64) over batch 2 x 4,096 tokens.
SSD_BC, SSD_H, SSD_Q, SSD_P, SSD_N = 2 * 4096 // 256, 32, 256, 64, 128
#: (batch*chunks, heads) of the SSD cell's few-cell timings, at Q, N and P
#: as above.
SSD_SMALL_CELLS = ((1, 1), (1, 8), (2, 8), (4, 8), (8, 8), (16, 8), (4, 32),
                   (8, 32), (16, 32))

def lm_kernels(torch, np, emit, hopper) -> list[dict]:
    """Phases 8 and 9: the attention and SSD kernels against their plain
    versions at small shapes, then the qwen3-0.6b forward at full width
    with the attention kernel's launches counted, its logits held against
    the blockwise path in bf16 and in f32, and both kernels timed at the
    full-width shapes; returns their entries of the kernels line."""
    import dataclasses
    import importlib

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ref, ssd_intra
    from repro_torch.models import counting, transformer

    fmod = importlib.import_module("repro_torch.kernels.flash_attention")
    smod = importlib.import_module("repro_torch.kernels.ssd_intra")
    f32, bf16 = torch.float32, torch.bfloat16

    def dev(a, dtype=f32):
        a = np.ascontiguousarray(a, np.float32)
        return torch.from_numpy(a).to(dtype).cuda()

    def ssd_inputs(rng, bc, h, q, p, n, steep, dtype=f32):
        step = rng.uniform(1.0, 4.0, (bc, h, q)) if steep else \
            rng.uniform(0.005, 1.0, (bc, h, q))
        return (dev(rng.normal(size=(bc, h, q, p)), dtype),
                dev(rng.normal(size=(bc, q, n)), dtype),
                dev(rng.normal(size=(bc, q, n)), dtype),
                dev(np.cumsum(-step, axis=-1), dtype))

    # ---- 8. both kernels against their plain versions, small shapes
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    # (kernel, case, [kernel outputs], [plain], rule, the kernel's path)
    checks = []
    for dtype in (f32, bf16):
        for bh, sq, sk, d, group in ((2, 37, 37, 64, 1), (4, 300, 300, 128, 2),
                                     (2, 1, 1, 128, 2), (4, 37, 300, 128, 2),
                                     (2, 300, 37, 64, 1), (4, 1, 300, 64, 2),
                                     (4, 300, 300, 80, 2),
                                     (4, 300, 300, 112, 1),
                                     (4, 300, 300, 40, 2),
                                     (2, 300, 300, 120, 1),
                                     (4, 37, 1500, 64, 1)):
            for causal in (True, False):
                q = dev(rng.normal(size=(bh, sq, d)), dtype)
                k = dev(rng.normal(size=(bh // group, sk, d)), dtype)
                v = dev(rng.normal(size=(bh // group, sk, d)), dtype)
                path = fmod.attention_path(q, k, v)
                want_path = "f32" if dtype == f32 else \
                    "wgmma" if d % 8 == 0 else "mma_sync"
                case = (f"bh={bh} sq={sq} sk={sk} d={d} group={group} "
                        f"causal={causal} {str(dtype)[6:]}")
                if path != want_path:
                    raise SystemExit(f"lm_vs_plain: flash_attention {case} "
                                     f"takes the {path} kernel, not the "
                                     f"{want_path} one")
                bq, bk = fmod.kernel_tiles(path)
                got = fmod.flash_attention(q, k, v, causal=causal,
                                           group=group)
                want = fmod.flash_attention_plain(q, k, v, causal=causal,
                                                  group=group, bq=bq, bk=bk)
                checks.append(("flash_attention", case, [got], [want],
                               "allclose" if dtype == f32 else "attn_bf16",
                               path))
                if path == "wgmma" and d not in (64, 128):
                    # the design these widths left, on the same operands
                    mq, mk = fmod.kernel_tiles("mma_sync")
                    checks.append((
                        "flash_attention", case,
                        [fmod.launch(q, k, v, "mma_sync", causal=causal,
                                     group=group)],
                        [fmod.flash_attention_plain(
                            q, k, v, causal=causal, group=group, bq=mq,
                            bk=mk)], "attn_bf16", "mma_sync"))
    # the SSD cell: through the entry point (the kernel ssd_path names);
    # where that is the wgmma one, also the first design by name, and the
    # wgmma outputs held to the f64 rule too (ssd_f64 below)
    ssd_f64 = []
    for shape, dts in (
            ((2, 3, 8, 4, 5, False), None), ((1, 2, 4, 8, 3, False), None),
            ((1, 2, 64, 8, 6, True), None),
            ((2, 4, SSD_Q, SSD_P, SSD_N, True), None),
            ((1, 2, 100, 70, 70, False), None),
            ((3, 5, 128, 64, 64, False), None),
            ((2, 17, 256, 64, 192, False), None),
            ((2, 9, SSD_Q, SSD_P, SSD_N, True), (f32, bf16, f32, bf16)),
            ((2, 9, SSD_Q, SSD_P, SSD_N, True), (bf16, f32, f32, f32)),
            ((2, 9, SSD_Q, SSD_P, SSD_N, True), (f32, bf16, bf16, f32)),
            ((1, 1, 64, SSD_P, 64, False), None),
            ((2, 3, 192, SSD_P, SSD_N, True), None),
            ((4, 1, SSD_Q, SSD_P, SSD_N, True), None)):
        for dtype in (f32, bf16) if dts is None else (None,):
            args = ssd_inputs(rng, *shape, dtype=dtype or f32)
            if dts is not None:
                args = tuple(a.to(d) for a, d in zip(args, dts))
            case = f"(bc, h, q, p, n, steep)={shape} " + (
                str(dtype)[6:] if dts is None else
                "xdt, bb, cc, cs " + "/".join(str(d)[6:] for d in dts))
            path = smod.ssd_path(*args)
            want_path = "wgmma" if shape[3] == 64 and shape[2] % 64 == 0 \
                and shape[4] % 64 == 0 else "simt"
            if path != want_path:
                raise SystemExit(f"lm_vs_plain: ssd_intra {case} takes the "
                                 f"{path} kernel, not the {want_path} one")
            got = list(ssd_intra(*args))
            if any(g.dtype != f32 for g in got):
                raise SystemExit(f"lm_vs_plain: ssd_intra on {case} "
                                 f"returns {[g.dtype for g in got]}")
            want = list(ref.ssd_intra_ref(*args))
            checks.append(("ssd_intra", case, got, want, "ssd", path))
            if path == "wgmma":
                exact = ref.ssd_intra_ref(*args, dtype=torch.float64)
                fed = list(smod.launch(*args, "wgmma_thread_fed"))
                checks.append(("ssd_intra", case,
                               list(smod.launch(*args, "simt")), want, "ssd",
                               "simt"))
                checks.append(("ssd_intra", case, fed, want, "ssd",
                               "wgmma_thread_fed"))
                ssd_f64.append((case, "wgmma", got, want, exact))
                ssd_f64.append((case, "wgmma_thread_fed", fed, want, exact))
    torch.cuda.synchronize()
    small_err = {}
    for name, case, got, want, rule, path in checks:
        for g, w in zip(got, want):
            ok, diff = agree(torch, g, w, rule)
            small_err[name] = max(small_err.get(name, 0.0), diff)
            if not ok:
                raise SystemExit(f"lm_vs_plain: {name} {case} ({path}): "
                                 f"kernel disagrees with the plain version "
                                 f"({TOLERANCES[rule]}; max abs diff {diff})")
            if path is not None:
                line = {"phase": "lm_vs_plain", "kernel": name, "case": case,
                        "path": path, "max_abs_diff_vs_plain": diff}
                if rule == "attn_bf16":
                    line["limit_share"] = limit_share(torch, g, w, rule)
                emit(line)
    f64_share = 0.0
    for case, path, got, want, exact in ssd_f64:
        shares = [tf32x3_share(torch, g, w, e)
                  for g, w, e in zip(got, want, exact)]
        f64_share = max(f64_share, *shares)
        emit({"phase": "lm_vs_plain", "kernel": "ssd_intra", "case": case,
              "path": path, "rule": "ssd_f64", "limit_share_y_s": shares})
        if max(shares) > 1.0:
            raise SystemExit(f"lm_vs_plain: ssd_intra {case} ({path}) "
                             f"misses the f64 rule "
                             f"({TOLERANCES['ssd_f64']}; {shares} of the "
                             f"limit)")
    emit({"phase": "lm_vs_plain", "cases": len(checks),
          "max_abs_diff_vs_plain": small_err, "all_agree": True,
          "ssd_f64_max_limit_share": f64_share,
          "tolerances": {"flash_attention f32": TOLERANCES["allclose"],
                         "flash_attention bf16": TOLERANCES["attn_bf16"],
                         "ssd_intra": [TOLERANCES["ssd"],
                                       TOLERANCES["ssd_f64"]]},
          "seconds": time.perf_counter() - t0})
    del checks, ssd_f64

    # ---- 9. the qwen3-0.6b forward at full width
    cfg = dataclasses.replace(get_config(LM_ARCH), use_pallas_attention=True)
    plain_cfg = dataclasses.replace(cfg, use_pallas_attention=False)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(42).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_SEQ))).cuda()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = LM_BATCH * LM_SEQ

    by_path = fmod.flash_attention.launches_by_path
    fmod.flash_attention.launches = 0         # zero just before the path
    for p in by_path:
        by_path[p] = 0
    logits = transformer.forward(cfg, params, toks)
    torch.cuda.synchronize()
    launches = fmod.flash_attention.launches  # read just after
    attn_by_path = dict(by_path)
    if launches != cfg.num_layers or attn_by_path["wgmma"] != launches:
        raise SystemExit(f"lm_full_width: {launches} flash_attention "
                         f"launches in one forward ({attn_by_path} by "
                         f"kernel), not {cfg.num_layers} on the wgmma one")
    if logits.shape != (LM_BATCH, LM_SEQ, cfg.vocab_padded) \
            or logits.dtype != f32:
        raise SystemExit(f"lm_full_width: logits {tuple(logits.shape)} "
                         f"{logits.dtype}")
    plain = transformer.forward(plain_cfg, params, toks)
    torch.cuda.synchronize()
    vocab = cfg.vocab_size                    # padded columns are -1e30
    logits, plain = logits[..., :vocab], plain[..., :vocab]
    ok, diff_bf16 = agree(torch, logits, plain, "lm_bf16")
    max_logit = float(plain.abs().max())
    mean_rel = float((logits - plain).abs().mean() / plain.abs().mean())
    if not ok:
        raise SystemExit(f"lm_full_width: bf16 logits disagree with the "
                         f"blockwise path ({TOLERANCES['lm_bf16']}; max "
                         f"abs diff {diff_bf16}, max |logit| {max_logit})")
    del logits, plain

    # the forward's time and its split (CUDA events, median of 5)
    def fwd():
        return transformer.forward(cfg, params, toks)

    # the forward and its two parts one after the other, before the
    # blockwise path fills the allocator's cache
    forward_ms = median_ms(torch, fwd, reps=5)
    hidden = transformer.hidden_states(cfg, params, toks)
    hidden_ms = median_ms(
        torch, lambda: transformer.hidden_states(cfg, params, toks), reps=5)
    head_ms = median_ms(
        torch, lambda: transformer.logits_fn(cfg, params, hidden), reps=5)
    del hidden
    plain_forward_ms = median_ms(
        torch, lambda: transformer.forward(plain_cfg, params, toks), reps=3)
    n_params = counting.param_count(cfg)
    attn_flops = 2.0 * LM_SEQ * LM_SEQ * cfg.hd * cfg.num_heads * LM_BATCH \
        * cfg.num_layers                      # causal half, QK^T and PV
    # the 2 N D convention counts the embedding table, a gather that does
    # no products; the bound counts the layers and the LM head only
    convention_flops = counting.model_flops(cfg, tokens, "prefill")
    fwd_flops = convention_flops - 2.0 * tokens * cfg.vocab_padded \
        * cfg.d_model + attn_flops
    fwd_bound_ms = fwd_flops / PEAK_BF16_OPS * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the same weights, widened to f32, through both paths in f32
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")

    def widen(tree):
        return {k: widen(a) if isinstance(a, dict) else a.float()
                for k, a in tree.items()}

    params32 = widen(params)
    del params
    torch.cuda.empty_cache()
    logits = transformer.forward(cfg32, params32, toks)
    plain = transformer.forward(dataclasses.replace(
        cfg32, use_pallas_attention=False), params32, toks)
    torch.cuda.synchronize()
    logits, plain = logits[..., :vocab], plain[..., :vocab]
    ok, diff_f32 = agree(torch, logits, plain, "lm_f32")
    max_logit32 = float(plain.abs().max())
    if not ok:
        raise SystemExit(f"lm_full_width: f32 logits disagree with the "
                         f"blockwise path ({TOLERANCES['lm_f32']}; max "
                         f"abs diff {diff_f32}, max |logit| {max_logit32})")
    del logits, plain, params32
    torch.cuda.empty_cache()
    emit({"phase": "lm_full_width", "arch": LM_ARCH, "layers":
          cfg.num_layers, "batch": LM_BATCH, "seq": LM_SEQ,
          "params": n_params, "init_s": init_s,
          "flash_attention_launches": launches,
          "flash_attention_launches_by_path": attn_by_path,
          "bf16_max_abs_diff_vs_blockwise": diff_bf16,
          "bf16_mean_rel_diff_vs_blockwise": mean_rel,
          "bf16_max_abs_logit": max_logit,
          "bf16_tolerance": TOLERANCES["lm_bf16"],
          "f32_max_abs_diff_vs_blockwise": diff_f32,
          "f32_max_abs_logit": max_logit32,
          "f32_tolerance": TOLERANCES["lm_f32"],
          "forward_ms": forward_ms, "tokens_per_s": tokens / forward_ms * 1e3,
          "blockwise_forward_ms": plain_forward_ms,
          "hidden_states_ms": hidden_ms, "lm_head_f32_ms": head_ms,
          "forward_flops": fwd_flops, "attention_flops": attn_flops,
          "model_flops_2nd_with_embedding": convention_flops,
          "forward_bound_ms": fwd_bound_ms, "bound_by": "operations",
          "of_bound": fwd_bound_ms / forward_ms, "peak_memory_gb": peak_gb})

    # ---- the kernels at the path's full-width shapes, timed
    g = cfg.num_heads // cfg.num_kv_heads
    bh = LM_BATCH * cfg.num_heads
    q = dev(rng.normal(size=(bh, LM_SEQ, cfg.hd)), bf16)
    k = dev(rng.normal(size=(bh // g, LM_SEQ, cfg.hd)), bf16)
    v = dev(rng.normal(size=(bh // g, LM_SEQ, cfg.hd)), bf16)
    path = fmod.attention_path(q, k, v)
    if path != "wgmma":
        raise SystemExit(f"lm_full_width: one layer's attention takes the "
                         f"{path} kernel")
    got = fmod.flash_attention(q, k, v, causal=True, group=g)
    bq, bk = fmod.kernel_tiles(path)
    want = fmod.flash_attention_plain(q, k, v, causal=True, group=g,
                                      bq=bq, bk=bk)
    ok, flash_diff = agree(torch, got, want, "attn_bf16")
    # the largest share of its element's limit that a difference takes
    share = limit_share(torch, got, want, "attn_bf16")
    if not ok:
        raise SystemExit(f"lm_full_width: flash_attention ({bh}, {LM_SEQ}, "
                         f"{cfg.hd}) disagrees with the plain version "
                         f"({TOLERANCES['attn_bf16']}; max abs diff "
                         f"{flash_diff}, {share} of the limit)")
    del got, want
    bq = bk = min(cfg.q_chunk, 128)           # the plain version's timing
    q4 = q.view(LM_BATCH, cfg.num_heads, LM_SEQ, cfg.hd)
    k4 = k.view(LM_BATCH, cfg.num_kv_heads, LM_SEQ, cfg.hd
                ).repeat_interleave(g, 1)
    v4 = v.view(LM_BATCH, cfg.num_kv_heads, LM_SEQ, cfg.hd
                ).repeat_interleave(g, 1)
    flash_flops = 2.0 * LM_SEQ * LM_SEQ * cfg.hd * bh
    flash_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    flash = dict(
        ms=median_ms(torch, lambda: fmod.flash_attention(q, k, v, causal=True,
                                                         group=g),
                     inner=INNER),
        plain_ms=median_ms(torch, lambda: fmod.flash_attention_plain(
            q, k, v, causal=True, group=g, bq=bq, bk=bk), reps=3),
        library_ms=median_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), inner=INNER),
        # the mma.sync kernel this one replaced, at the same shape
        previous_ms=median_ms(torch, lambda: fmod.launch(
            q, k, v, "mma_sync", causal=True, group=g), inner=INNER),
        path=path, ptxas_and_sass=hopper["flash_attention"],
        max_abs_err=flash_diff, limit_share=share,
        tolerance=TOLERANCES["attn_bf16"], flops=flash_flops,
        bytes=flash_bytes,
        shape=f"q ({bh}, {LM_SEQ}, {cfg.hd}) bf16, k/v ({bh // g}, "
              f"{LM_SEQ}, {cfg.hd}), group {g}, causal")
    flash["bound_ms"], flash["bound_by"] = bound(flash_flops, flash_bytes,
                                                 PEAK_BF16_OPS)
    del q, k, v, q4, k4, v4

    # the SSD cell at mamba2-370m's widths through the entry point: its
    # launches counted by kernel, all on the wgmma one
    args = ssd_inputs(rng, SSD_BC, SSD_H, SSD_Q, SSD_P, SSD_N, False)
    smod.ssd_intra.launches = 0               # its path: the entry point
    for p in smod.ssd_intra.launches_by_path:
        smod.ssd_intra.launches_by_path[p] = 0
    got = ssd_intra(*args)
    torch.cuda.synchronize()
    ssd_launches = smod.ssd_intra.launches
    ssd_by_path = dict(smod.ssd_intra.launches_by_path)
    if ssd_launches <= 0 or ssd_by_path != {"wgmma": ssd_launches,
                                             "simt": 0,
                                             "wgmma_thread_fed": 0}:
        raise SystemExit(f"lm_full_width: ssd_intra launched {ssd_by_path}, "
                         f"not the wgmma kernel alone")
    del got
    tri = SSD_Q * (SSD_Q + 1) // 2            # (i, j) pairs with j <= i
    cells = SSD_BC * SSD_H
    # G counted once a batch*chunk (it depends on bb and cc alone), y and
    # S once a cell; the first design's count, G once a cell, beside it
    ssd_flops = 2.0 * (SSD_BC * tri * SSD_N + cells * tri * SSD_P
                       + cells * SSD_Q * SSD_N * SSD_P)
    per_cell_flops = 2.0 * cells * (tri * SSD_N + tri * SSD_P
                                    + SSD_Q * SSD_N * SSD_P)
    ssd_bytes = 4 * (2 * cells * SSD_Q * SSD_P + 2 * SSD_BC * SSD_Q * SSD_N
                     + cells * SSD_Q + cells * SSD_N * SSD_P)
    bf16_saved = 2 * (cells * SSD_Q * SSD_P + 2 * SSD_BC * SSD_Q * SSD_N
                      + cells * SSD_Q)

    g_flops = 2.0 * SSD_BC * tri * SSD_N

    def ssd_full(args, nbytes, tc_flops, dtype_name):
        """Both rules, the first design on the same inputs, and the times
        of the kernel, the first design and the plain version, beside the
        bounds: the tensor cores' tf32 products (``tc_flops``: three of
        each product of the count with G once a batch*chunk for f32
        inputs, one fewer for each bf16 operand), that count on the CUDA
        cores, the first design's count (G once a cell) on them, and the
        bytes."""
        got = ssd_intra(*args)
        want = ref.ssd_intra_ref(*args)
        exact = ref.ssd_intra_ref(*args, dtype=torch.float64)
        first = smod.launch(*args, "simt")
        fed = smod.launch(*args, "wgmma_thread_fed")
        diff = share = 0.0
        for gt, wt, ex, ft, xt in zip(got, want, exact, first, fed):
            if tf32x3_share(torch, xt, wt, ex) > 1.0:
                raise SystemExit(f"lm_full_width: ssd_intra (thread-fed) on "
                                 f"{dtype_name} inputs misses the f64 rule")
            for g_, label in ((gt, "the wgmma kernel"),
                              (ft, "the first design"),
                              (xt, "the thread-fed variant")):
                ok, d = agree(torch, g_, wt, "ssd")
                if not ok or g_.dtype != f32:
                    raise SystemExit(
                        f"lm_full_width: ssd_intra ({label}) on "
                        f"{dtype_name} inputs at mamba2-370m's shape "
                        f"disagrees with the plain version "
                        f"({TOLERANCES['ssd']}; max abs diff {d})")
                if g_ is gt:
                    diff = max(diff, d)
            share = max(share, tf32x3_share(torch, gt, wt, ex))
        if share > 1.0:
            raise SystemExit(f"lm_full_width: ssd_intra on {dtype_name} "
                             f"inputs misses the f64 rule "
                             f"({TOLERANCES['ssd_f64']}; {share} of the "
                             f"limit)")
        del got, want, exact, first, fed
        bounds = {"tf32x3_tensor_cores_ms": tc_flops / PEAK_TF32_OPS * 1e3,
                  "cuda_cores_ms": ssd_flops / PEAK_F32_OPS * 1e3,
                  "per_cell_G_cuda_cores_ms": per_cell_flops / PEAK_F32_OPS
                  * 1e3,
                  "bytes_ms": nbytes / PEAK_BYTES * 1e3}
        r = dict(
            ms=median_ms(torch, lambda: ssd_intra(*args), inner=INNER),
            previous_ms=median_ms(torch, lambda: smod.launch(*args, "simt"),
                                  reps=3, inner=INNER),
            thread_fed_ms=median_ms(
                torch, lambda: smod.launch(*args, "wgmma_thread_fed"),
                inner=INNER),
            plain_ms=median_ms(torch, lambda: ref.ssd_intra_ref(*args),
                               reps=3),
            library_ms=None, max_abs_err=diff, path="wgmma",
            plan={"heads_per_cta": smod.ssd_plan(SSD_BC, SSD_H, SSD_Q,
                                                 SSD_N)},
            f64_limit_share=share, flops=ssd_flops,
            per_cell_G_flops=per_cell_flops, bytes=nbytes, bounds_ms=bounds,
            tolerance=[TOLERANCES["ssd"], TOLERANCES["ssd_f64"]],
            shape=f"xdt ({SSD_BC}, {SSD_H}, {SSD_Q}, {SSD_P}), bb/cc "
                  f"({SSD_BC}, {SSD_Q}, {SSD_N}) {dtype_name}, outputs f32")
        r["bound_ms"], r["bound_by"] = bound(tc_flops, nbytes, PEAK_TF32_OPS)
        r["tensor_core_flops"] = tc_flops
        return r

    ssd = ssd_full(args, ssd_bytes, 3 * ssd_flops, "float32")
    # the same cell on bf16 inputs (f32 outputs), timed beside it: G in one
    # tf32 pass, y and S (one bf16 operand each) in two
    ssd16 = ssd_full([a.to(bf16) for a in args], ssd_bytes - bf16_saved,
                     g_flops + 2 * (ssd_flops - g_flops), "bfloat16")
    del args
    # few cells: the wgmma kernel at ssd_plan's heads a CTA beside the
    # first design, and at each other choice of heads a CTA from CUDA
    # graphs (what ssd_plan's choice rests on)
    small_cells = []
    for bc, h in SSD_SMALL_CELLS:
        a = ssd_inputs(rng, bc, h, SSD_Q, SSD_P, SSD_N, False)
        if smod.ssd_path(*a) != "wgmma":
            raise SystemExit(f"lm_full_width: ssd_intra at {bc} x {h} cells "
                             f"does not take the wgmma kernel")
        small_cells.append({
            "bc": bc, "h": h, "heads_per_cta": smod.ssd_plan(
                bc, h, SSD_Q, SSD_N),
            "ms": median_ms(torch, lambda: ssd_intra(*a), inner=INNER),
            "previous_ms": median_ms(torch, lambda: smod.launch(*a, "simt"),
                                     inner=INNER),
            "graph_ms_by_heads": {
                hg: graph_ms(torch, lambda: smod.launch(*a, "wgmma",
                                                        heads=hg))
                for hg in (1, 2, 4, 8) if hg <= h},
            "previous_graph_ms": graph_ms(
                torch, lambda: smod.launch(*a, "simt"))})
        del a
    ssd["small_cells"] = small_cells
    for name, r in (("flash_attention", flash), ("ssd_intra", ssd),
                    ("ssd_intra", ssd16)):
        emit({"phase": "lm_full_width", "kernel": name, **r,
              "of_bound": r["bound_ms"] / r["ms"]})
    emit({"phase": "lm_full_width", "launches": {
        "flash_attention": launches, "ssd_intra": ssd_launches},
        "ssd_intra_launches_by_path": ssd_by_path, "all_agree": True})

    out = []
    for name, r, n, replaces in (
            ("flash_attention", flash, launches,
             "src/repro/kernels/flash_attention.py:70"),
            ("ssd_intra", ssd, ssd_launches,
             "src/repro/kernels/ssd_intra.py:44")):
        out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "replaces_function": name,
            "launches": n, "max_abs_err": r["max_abs_err"],
            "max_abs_diff_vs_plain": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
            **{k: r[k] for k in ("previous_ms", "thread_fed_ms", "path",
                                 "bounds_ms", "plan", "f64_limit_share",
                                 "small_cells") if k in r}})
        if name == "ssd_intra":
            out[-1].update(launches_by_path=ssd_by_path, bf16_inputs={
                k: ssd16[k] for k in ("ms", "previous_ms", "thread_fed_ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "f64_limit_share", "max_abs_err")})
    return out


#: Phase 10, serving: qwen3-0.6b's prefill of LM_BATCH x SERVE_PROMPT
#: tokens into a cache of SERVE_MAX_LEN slots, then SERVE_DECODE
#: teacher-forced decode steps; the engine's requests, prompt length, new
#: tokens and preemption point, on qwen3-0.6b and on mamba2-370m; mamba2's
#: forward over LM_BATCH x LM_SEQ tokens and its teacher-forced decode over
#: LM_BATCH x SSM_DECODE in bf16 and LM_BATCH x SSM_DECODE_F32 in f32 (a
#: decode step is host-bound at some 12 us an eager op: lower these if the
#: time limit forces it).
SERVE_PROMPT, SERVE_MAX_LEN, SERVE_DECODE = 4096, 4160, 32
ENGINE_RUNS = {"qwen3-0.6b": (4, 64, 32), "mamba2-370m": (2, 32, 16)}
ENGINE_FAIL_AFTER = 8
SSM_ARCH = "mamba2-370m"
SSM_DECODE, SSM_DECODE_F32 = 256, 64

def live_ssd(torch, params, conv: float = 50.0) -> dict:
    """A copy of a mamba2 parameter tree whose SSD output matters: conv
    taps x ``conv``, ``dt_bias`` 0 (softplus(dt) about 0.7); with the init
    recipe (taps at std 0.02, ``dt_bias`` -4) it is 1e-6 of the skip
    path's."""
    layers = dict(params["layers"], conv_w=params["layers"]["conv_w"] * conv,
                  dt_bias=torch.zeros_like(params["layers"]["dt_bias"]))
    return dict(params, layers=layers)


def engine_runs(torch, cfg, params, requests, root) -> dict:
    """``ServeEngine`` on ``requests`` (rid, prompt, max_new): twice from
    fresh state, then preempted after ENGINE_FAIL_AFTER tokens and resumed
    by a fresh engine on the same state.  Every run's tokens must equal the
    first's bit for bit.  Each run's wall is split into decode (each
    ``decode_step`` call up to a ``synchronize``) and cursor commits."""
    from repro_torch.serving import Request, ServeEngine

    prompt_len, max_new = len(requests[0][1]), requests[0][2]

    def run(name, state, fail_after=None):
        eng = ServeEngine(cfg, params, root / state,
                          max_len=prompt_len + max_new)
        clock = {"decode_s": 0.0, "decode_steps": 0, "commit_s": 0.0,
                 "commits": 0}
        decode, cursor = eng._decode, eng._cursor

        def timed_decode(*a):
            t0 = time.perf_counter()
            out = decode(*a)
            torch.cuda.synchronize()
            clock["decode_s"] += time.perf_counter() - t0
            clock["decode_steps"] += 1
            return out

        def timed_cursor(rid):
            cur = cursor(rid)
            commit = cur.commit

            def timed_commit(**fields):
                t0 = time.perf_counter()
                commit(**fields)
                clock["commit_s"] += time.perf_counter() - t0
                clock["commits"] += 1
            cur.commit = timed_commit
            return cur

        eng._decode, eng._cursor = timed_decode, timed_cursor
        reqs = [Request(rid, list(p), n) for rid, p, n in requests]
        t0 = time.perf_counter()
        try:
            if fail_after is None:
                out = eng.run(reqs)
            else:
                try:
                    eng.run(reqs, fail_after_tokens=fail_after)
                except RuntimeError as e:     # the simulated preemption
                    if str(e) != "preempted":
                        raise
                else:
                    raise SystemExit(f"serving: the engine was not "
                                     f"preempted after {fail_after} tokens")
                out = None
        finally:
            # the timers hold the engine's own methods: a reference cycle
            # that would keep the engine, and the weights, alive until the
            # collector ran
            del eng._decode, eng._cursor
        return out, dict(clock, run=name, wall_s=time.perf_counter() - t0)

    first, c1 = run("first", "a")
    second, c2 = run("second", "b")
    _, c3 = run("preempted", "c", ENGINE_FAIL_AFTER)
    resumed, c4 = run("resumed", "c")
    if second != first:
        raise SystemExit(f"serving: {cfg.name}'s engine gave other tokens "
                         f"on a second run")
    if resumed != first:
        raise SystemExit(f"serving: {cfg.name}'s engine resumed after "
                         f"preemption gave other tokens than the "
                         f"uninterrupted run")
    if any(len(t) != max_new for t in first.values()):
        raise SystemExit(f"serving: {cfg.name}'s engine emitted "
                         f"{[len(t) for t in first.values()]} tokens")
    return {"arch": cfg.name, "requests": len(requests),
            "prompt_len": prompt_len, "max_new": max_new,
            "fail_after_tokens": ENGINE_FAIL_AFTER,
            "tokens_equal_across_runs": True,
            "tokens_equal_after_preemption": True,
            "first_tokens": first["r0"][:8], "runs": [c1, c2, c3, c4]}


def serving(torch, np, emit, smi_line) -> dict:
    """Phase 10: the serving path on the card.  qwen3-0.6b as published
    (28 layers, bf16, the flash kernel): ``prefill`` with the flash
    kernel's launches zeroed just before and read just after (one a layer,
    all on wgmma), its last logits and SERVE_DECODE teacher-forced
    ``decode_step``s held against the forward's at the same positions
    (lm_bf16), timed beside a decode step's byte bound; ``ServeEngine``
    (``engine_runs``).  mamba2-370m as published (48 layers, bf16):
    ``forward`` with ``ssd_intra``'s launches zeroed just before and read
    just after (one a layer, all on wgmma), each launch held against the
    plain cell on its inputs (``ssd_f64``), the logits against the same
    forward with the plain cell swapped in; teacher-forced decode against
    the forward in bf16 and in f32 (TOLERANCES); its engine.
    Returns the launches counted on the two paths."""
    import dataclasses
    import importlib
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.models import counting, mamba2, transformer

    fmod = importlib.import_module("repro_torch.kernels.flash_attention")
    smod = importlib.import_module("repro_torch.kernels.ssd_intra")
    f32 = torch.float32
    t_phase = time.perf_counter()
    emit({"phase": "serving", "nvidia_smi": smi_line})

    # ---- qwen3-0.6b: prefill, then teacher-forced decode
    cfg = dataclasses.replace(get_config(LM_ARCH), use_pallas_attention=True)
    params = transformer.init_params(cfg, seed=0, device="cuda")
    vocab = cfg.vocab_size
    toks = torch.from_numpy(np.random.default_rng(42).integers(
        0, vocab, (LM_BATCH, SERVE_PROMPT + SERVE_DECODE))).cuda()
    prompt = toks[:, :SERVE_PROMPT]
    by_path = fmod.flash_attention.launches_by_path
    fmod.flash_attention.launches = 0         # zero just before the path
    for p in by_path:
        by_path[p] = 0
    first, cache = transformer.prefill(cfg, params, prompt, SERVE_MAX_LEN)
    torch.cuda.synchronize()
    flash_launches = fmod.flash_attention.launches   # read just after
    flash_by_path = dict(by_path)
    if flash_launches != cfg.num_layers \
            or flash_by_path["wgmma"] != flash_launches:
        raise SystemExit(f"serving: {flash_launches} flash_attention "
                         f"launches in prefill ({flash_by_path} by kernel), "
                         f"not {cfg.num_layers} on the wgmma one")
    if first.shape != (LM_BATCH, cfg.vocab_padded) or first.dtype != f32 \
            or cache["k"].shape != (cfg.num_layers, LM_BATCH,
                                    cfg.num_kv_heads, SERVE_MAX_LEN, cfg.hd):
        raise SystemExit(f"serving: prefill gave logits "
                         f"{tuple(first.shape)} {first.dtype} and a cache "
                         f"{tuple(cache['k'].shape)}")
    steps = []
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    host_s = 0.0
    ev0.record()
    for j in range(SERVE_DECODE):
        pos = SERVE_PROMPT + j
        t0 = time.perf_counter()
        logits, cache = transformer.decode_step(cfg, params, cache,
                                                toks[:, pos], pos)
        host_s += time.perf_counter() - t0
        steps.append(logits)
    ev1.record()
    torch.cuda.synchronize()
    decode_ms = ev0.elapsed_time(ev1) / SERVE_DECODE
    # the forward's logits at the prompt's last position and at each
    # decoded one (one forward over every token, the head on those rows)
    hidden = transformer.hidden_states(cfg, params, toks)
    want = transformer.logits_fn(cfg, params,
                                 hidden[:, SERVE_PROMPT - 1:])[..., :vocab]
    del hidden
    ok, prefill_diff = agree(torch, first[:, :vocab], want[:, 0], "lm_bf16")
    prefill_share = scale_share(torch, first[:, :vocab], want[:, 0],
                                "lm_bf16")
    if not ok:
        raise SystemExit(f"serving: prefill's logits disagree with the "
                         f"forward's ({TOLERANCES['lm_bf16']}; max abs diff "
                         f"{prefill_diff}, {prefill_share} of the limit)")
    decode_share = decode_diff = 0.0
    for j, logits in enumerate(steps):
        ok, d = agree(torch, logits[:, :vocab], want[:, 1 + j], "lm_bf16")
        share = scale_share(torch, logits[:, :vocab], want[:, 1 + j],
                            "lm_bf16")
        decode_diff, decode_share = max(decode_diff, d), max(decode_share,
                                                            share)
        if not ok:
            raise SystemExit(f"serving: decode step {j} disagrees with the "
                             f"forward at position {SERVE_PROMPT + j} "
                             f"({TOLERANCES['lm_bf16']}; max abs diff {d}, "
                             f"{share} of the limit)")
    del steps, want
    prefill_ms = median_ms(torch, lambda: transformer.prefill(
        cfg, params, prompt, SERVE_MAX_LEN), reps=3)
    # one decode step's LM head alone (its f32 widening of the head)
    x1 = torch.zeros((LM_BATCH, 1, cfg.d_model), dtype=torch.bfloat16,
                     device=params["embed"].device)
    head_ms = median_ms(torch, lambda: transformer.logits_fn(cfg, params, x1),
                        inner=INNER)
    n_params = counting.param_count(cfg)
    # a decode step reads every weight once (the embedding: B rows) and
    # the valid K/V of every layer (at the mean position decoded)
    weight_bytes = 2 * (n_params - cfg.vocab_padded * cfg.d_model
                        + LM_BATCH * cfg.d_model)
    kv_bytes = 2 * 2 * cfg.num_layers * LM_BATCH * cfg.num_kv_heads \
        * cfg.hd * (SERVE_PROMPT + (SERVE_DECODE + 1) / 2)
    decode_bound_ms = (weight_bytes + kv_bytes) / PEAK_BYTES * 1e3
    emit({"phase": "serving", "part": "qwen3_prefill_decode", "arch":
          LM_ARCH, "layers": cfg.num_layers, "batch": LM_BATCH,
          "prompt": SERVE_PROMPT, "max_len": SERVE_MAX_LEN,
          "decode_steps": SERVE_DECODE,
          "flash_attention_launches": flash_launches,
          "flash_attention_launches_by_path": flash_by_path,
          "prefill_max_abs_diff_vs_forward": prefill_diff,
          "prefill_limit_share": prefill_share,
          "decode_max_abs_diff_vs_forward": decode_diff,
          "decode_limit_share": decode_share,
          "tolerance": TOLERANCES["lm_bf16"],
          "prefill_ms": prefill_ms,
          "prefill_tokens_per_s": LM_BATCH * SERVE_PROMPT / prefill_ms * 1e3,
          "decode_ms_per_step": decode_ms,
          "decode_host_ms_per_step": host_s / SERVE_DECODE * 1e3,
          "decode_tokens_per_s": LM_BATCH / decode_ms * 1e3,
          "decode_lm_head_f32_ms": head_ms,
          "decode_bound_ms": decode_bound_ms, "decode_bound_by": "bytes",
          "decode_bound_bytes": {"weights": weight_bytes, "kv": kv_bytes},
          "decode_of_bound": decode_bound_ms / decode_ms})
    del cache, first, x1

    # ---- ServeEngine on qwen3-0.6b, then (below) on mamba2-370m
    build = ROOT / "build"
    build.mkdir(exist_ok=True)

    with tempfile.TemporaryDirectory(dir=build) as tmp:
        line = engine_runs(torch, cfg, params,
                           engine_requests(np, LM_ARCH, vocab), Path(tmp))
    emit({"phase": "serving", "part": "engine", **line})
    del params, prompt, toks
    torch.cuda.empty_cache()

    # ---- mamba2-370m: the forward through ssd_intra, counted and checked
    mcfg = get_config(SSM_ARCH)
    mparams = mamba2.init_params(mcfg, seed=0, device="cuda")
    mvocab = mcfg.vocab_size
    mtoks = torch.from_numpy(np.random.default_rng(42).integers(
        0, mvocab, (LM_BATCH, LM_SEQ))).cuda()
    wrapper = mamba2.ssd_intra
    f64_share = plain_diff = 0.0
    first_args = []

    def checked(*args):
        """The wrapper, each launch's outputs held at once against the plain
        cell on the same inputs (ssd and ssd_f64)."""
        nonlocal f64_share, plain_diff
        got = wrapper(*args)
        if not first_args:
            first_args.append([a.clone() for a in args])
        want = ref.ssd_intra_ref(*args)
        exact = ref.ssd_intra_ref(*args, dtype=torch.float64)
        for g, w, e in zip(got, want, exact):
            share = tf32x3_share(torch, g, w, e)
            ok, d = agree(torch, g, w, "ssd")
            f64_share, plain_diff = max(f64_share, share), max(plain_diff, d)
            if share > 1.0 or not ok:
                raise SystemExit(f"serving: an ssd_intra launch in "
                                 f"{SSM_ARCH}'s forward misses its rules "
                                 f"({TOLERANCES['ssd']}; "
                                 f"{TOLERANCES['ssd_f64']}; max abs diff "
                                 f"{d}, {share} of the f64 limit)")
        return got

    ssd_counts = smod.ssd_intra.launches_by_path
    smod.ssd_intra.launches = 0               # zero just before the path
    for p in ssd_counts:
        ssd_counts[p] = 0
    mamba2.ssd_intra = checked
    try:
        logits = mamba2.forward(mcfg, mparams, mtoks)
        torch.cuda.synchronize()
    finally:
        mamba2.ssd_intra = wrapper
    ssd_launches = smod.ssd_intra.launches    # read just after
    ssd_by_path = dict(ssd_counts)
    if ssd_launches != mcfg.num_layers or ssd_by_path["wgmma"] != \
            ssd_launches:
        raise SystemExit(f"serving: {ssd_launches} ssd_intra launches in "
                         f"{SSM_ARCH}'s forward ({ssd_by_path} by kernel), "
                         f"not {mcfg.num_layers} on the wgmma one")
    if logits.shape != (LM_BATCH, LM_SEQ, mcfg.vocab_padded):
        raise SystemExit(f"serving: {SSM_ARCH} logits {tuple(logits.shape)}")
    mamba2.ssd_intra = ref.ssd_intra_ref      # the comparison run only
    try:
        plain = mamba2.forward(mcfg, mparams, mtoks)
        torch.cuda.synchronize()
    finally:
        mamba2.ssd_intra = wrapper
    ok, ssm_diff = agree(torch, logits[..., :mvocab], plain[..., :mvocab],
                         "lm_bf16")
    ssm_share = scale_share(torch, logits[..., :mvocab], plain[..., :mvocab],
                            "lm_bf16")
    if not ok:
        raise SystemExit(f"serving: {SSM_ARCH}'s logits disagree with the "
                         f"plain SSD cell's ({TOLERANCES['lm_bf16']}; max "
                         f"abs diff {ssm_diff}, {ssm_share} of the limit)")
    del logits, plain
    forward_ms = median_ms(torch, lambda: mamba2.forward(mcfg, mparams,
                                                         mtoks), reps=3)
    ssd_ms = median_ms(torch, lambda: smod.ssd_intra(*first_args[0]),
                       inner=INNER)
    del first_args

    # teacher-forced decode against the forward, in bf16 and in f32
    decode_lines = {}

    def widen(tree):
        return {k: widen(a) if isinstance(a, dict) else a.float()
                for k, a in tree.items()}

    for name, c, p, rule, n_tok in (
            ("bf16", mcfg, mparams, "ssm_decode_bf16", SSM_DECODE),
            ("f32_live", dataclasses.replace(mcfg, param_dtype="float32",
                                             compute_dtype="float32"),
             live_ssd(torch, widen(mparams)), "ssm_decode_f32",
             SSM_DECODE_F32)):
        dtoks = mtoks[:, :n_tok]
        want = mamba2.forward(c, p, dtoks)[..., :mvocab]
        cache = mamba2.init_cache(c, LM_BATCH, device="cuda")
        worst = 0.0
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        host_s = 0.0
        steps = []
        ev0.record()
        for pos in range(n_tok):
            t0 = time.perf_counter()
            logits, cache = mamba2.decode_step(c, p, cache, dtoks[:, pos],
                                               pos)
            host_s += time.perf_counter() - t0
            steps.append(logits[:, :mvocab])
        ev1.record()
        torch.cuda.synchronize()
        got = torch.stack(steps, dim=1)
        ok, worst = agree(torch, got, want, rule)
        share = scale_share(torch, got, want, rule)
        if not ok:
            raise SystemExit(f"serving: {SSM_ARCH}'s {name} decode "
                             f"disagrees with its forward "
                             f"({TOLERANCES[rule]}; max abs diff "
                             f"{worst}, {share} of the limit)")
        decode_lines[name] = {
            "tokens": n_tok, "max_abs_diff_vs_forward": worst,
            "limit_share": share, "tolerance": TOLERANCES[rule],
            "decode_ms_per_step": ev0.elapsed_time(ev1) / n_tok,
            "decode_host_ms_per_step": host_s / n_tok * 1e3}
        del want, cache, steps, got, dtoks
    emit({"phase": "serving", "part": "mamba2_forward_decode",
          "arch": SSM_ARCH, "layers": mcfg.num_layers, "batch": LM_BATCH,
          "seq": LM_SEQ, "ssd_intra_launches": ssd_launches,
          "ssd_intra_launches_by_path": ssd_by_path,
          "ssd_max_abs_diff_vs_plain": plain_diff,
          "ssd_f64_max_limit_share": f64_share,
          "ssd_tolerance": [TOLERANCES["ssd"], TOLERANCES["ssd_f64"]],
          "logits_max_abs_diff_vs_plain_cell": ssm_diff,
          "logits_limit_share": ssm_share,
          "logits_tolerance": TOLERANCES["lm_bf16"],
          "forward_ms": forward_ms,
          "forward_tokens_per_s": LM_BATCH * LM_SEQ / forward_ms * 1e3,
          "ssd_ms_per_launch": ssd_ms, "decode": decode_lines})

    with tempfile.TemporaryDirectory(dir=build) as tmp:
        line = engine_runs(torch, mcfg, mparams,
                           engine_requests(np, SSM_ARCH, mvocab), Path(tmp))
    emit({"phase": "serving", "part": "engine", **line})
    del mparams, mtoks
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    emit({"phase": "serving", "seconds": seconds, "all_agree": True})
    return {"flash_attention": flash_launches, "ssd_intra": ssd_launches,
            "flash_attention_by_path": flash_by_path,
            "ssd_intra_by_path": ssd_by_path, "seconds": seconds}


#: Phases 11-13 (``moe``, ``vlm``, ``train``).  qwen3-moe-30b-a3b at full
#: width (d_model 2,048, 32/4 heads, 128 experts top-8, expert d_ff 768,
#: capacity factor 1.25, groups of 256, vocab 151,936, bf16), its depth cut
#: to MOE_LAYERS of 48 (no kernel or routing shape depends on depth):
#: forward and prefill over MOE_BATCH x MOE_SEQ tokens, MOE_DECODE
#: teacher-forced decode steps at batch MOE_DECODE_BATCH, its engine
#: (ENGINE_RUNS), one block against the every-expert reference over
#: MOE_DENSE_REF_TOKENS tokens.  llama4-scout-17b-a16e at full width,
#: SCOUT_LAYERS of 48, over 1 x SCOUT_SEQ tokens.
MOE_ARCH, MOE_LAYERS, MOE_BATCH, MOE_SEQ = "qwen3-moe-30b-a3b", 12, 2, 2048
MOE_DECODE_BATCH, MOE_DECODE = 4, 16
MOE_DENSE_REF_TOKENS = 512
SCOUT_ARCH, SCOUT_LAYERS, SCOUT_SEQ = "llama4-scout-17b-a16e", 2, 2048
ENGINE_RUNS[MOE_ARCH] = (4, 64, 32)
#: internvl2-26b at full width, VLM_LAYERS of 48, over VLM_BATCH x (its 256
#: patch embeddings + VLM_TEXT tokens).
VLM_ARCH, VLM_LAYERS, VLM_BATCH, VLM_TEXT = "internvl2-26b", 2, 2, 1792
#: qwen3-0.6b as published: LM_TRAIN_STEPS steps at LM_TRAIN_BATCH x
#: LM_TRAIN_SEQ, a checkpoint every LM_TRAIN_CKPT steps, the resume check
#: at full width and LM_TRAIN_RESUME_LAYERS of 28 layers (its checkpoint
#: writes some 2 GB, not 7.5) failing at LM_TRAIN_FAIL_AT;
#: mamba2-370m as published, SSM_TRAIN_STEPS
#: at SSM_TRAIN_BATCH x LM_TRAIN_SEQ.  Gradients through a kernel against
#: the plain version's: ||g_kernel - g_plain|| / ||g_plain|| per leaf.
LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ = 4, 4, 1024
LM_TRAIN_CKPT, LM_TRAIN_FAIL_AT, LM_TRAIN_RESUME_LAYERS = 2, 3, 2
SSM_TRAIN_STEPS, SSM_TRAIN_BATCH = 2, 2
GRAD_REL = 2e-2
#: ``train_microbatched`` at full width and LM_TRAIN_RESUME_LAYERS layers
#: (each f32 accumulator commit some 0.8 GB; 2.4 GB at all 28):
#: LM_MB_STEPS steps of LM_TRAIN_BATCH x LM_TRAIN_SEQ in
#: LM_MB_MICROBATCHES microbatches, a run failed just before microbatch
#: LM_MB_FAIL_AT = (step, microbatch) and resumed.
LM_MB_STEPS, LM_MB_MICROBATCHES, LM_MB_FAIL_AT = 2, 2, (1, 1)


def engine_requests(np, arch: str, vocab: int) -> list:
    """ENGINE_RUNS[arch]'s requests: (rid, prompt, max_new), seeded."""
    n, plen, new = ENGINE_RUNS[arch]
    rng = np.random.default_rng(0)
    return [(f"r{i}", rng.integers(0, vocab, plen).tolist(), new)
            for i in range(n)]


def zero_flash(fmod) -> None:
    fmod.flash_attention.launches = 0
    for p in fmod.flash_attention.launches_by_path:
        fmod.flash_attention.launches_by_path[p] = 0


def aten_calls(torch, fn) -> int:
    """The aten operations one ``fn()`` dispatches (a
    ``TorchDispatchMode`` counting them; the ctypes kernels are not aten
    operations)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def lm_forward_pair(torch, emit, fmod, cfg, params, label, *args,
                    published: int, smi_line="") -> tuple:
    """``forward`` with the flash kernel, its launches zeroed just before
    and read just after (one a layer, all on wgmma), against the same
    forward with the plain attention (``use_pallas_attention=False``)
    under ``lm_bf16``; ``published`` is the config's published depth.

    In a MoE model the plain forward takes the kernel forward's routing
    (each block's ``moe._route`` output replayed): capacity-bounded
    routing is not a continuous function, and on random weights most
    tokens pick the same experts, so a router logit that one rounding
    moves past another sends a slot elsewhere and, a cumulative sum later,
    moves every later token's place in that expert and which of them are
    dropped.  The same plain forward with its own routing is reported
    beside it (slots routed elsewhere, its share of the limit), not held.
    Returns (launches, kernel logits, line)."""
    import dataclasses

    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer

    plain_cfg = dataclasses.replace(cfg, use_pallas_attention=False)
    v = cfg.vocab_size
    routes, real_route = [], moe_mod._route

    def recording(*a):
        out = real_route(*a)
        routes.append(out)
        return out

    extra = {}
    moe_mod._route = recording
    try:
        zero_flash(fmod)
        got = transformer.forward(cfg, params, *args)
        torch.cuda.synchronize()
        launches = fmod.flash_attention.launches
        by_path = dict(fmod.flash_attention.launches_by_path)
        kernel_routes = list(routes)
        if cfg.is_moe:
            routes.clear()
            free = transformer.forward(plain_cfg, params, *args)
            slots = sum(r[1].numel() for r in kernel_routes)
            extra = {
                "routing": "the plain forward takes the kernel forward's",
                "token_slots": slots,
                "dropped_share": sum(int((~r[3]).sum())
                                     for r in kernel_routes) / slots,
                "own_routing_slots_elsewhere": sum(
                    int((a[1] != b[1]).sum())
                    for a, b in zip(kernel_routes, routes)),
                "own_routing_limit_share": scale_share(
                    torch, got[..., :v], free[..., :v], "lm_bf16")}
            del free
            replay = iter(kernel_routes)
            moe_mod._route = lambda *a: next(replay)
        plain = transformer.forward(plain_cfg, params, *args)
        torch.cuda.synchronize()
    finally:
        moe_mod._route = real_route
    del routes, kernel_routes
    ok, diff = agree(torch, got[..., :v], plain[..., :v], "lm_bf16")
    share = scale_share(torch, got[..., :v], plain[..., :v], "lm_bf16")
    del plain
    line = {"part": label, "arch": cfg.name, "layers": cfg.num_layers,
            "reduced": f"{cfg.num_layers} of {published} layers; full "
                       f"width", "shape": list(args[0].shape),
            "flash_attention_launches": launches,
            "flash_attention_launches_by_path": by_path,
            "max_abs_diff_vs_plain_attention": diff,
            "limit_share": share, "tolerance": TOLERANCES["lm_bf16"],
            **extra, "finite": bool(torch.isfinite(got).all()),
            "nvidia_smi": smi_line}
    if launches != cfg.num_layers or by_path["wgmma"] != launches:
        emit({"phase": "moe_vlm_failed", **line})
        raise SystemExit(f"{label}: {launches} flash_attention launches "
                         f"({by_path} by kernel), not {cfg.num_layers} on "
                         f"the wgmma one")
    if not ok:
        emit({"phase": "moe_vlm_failed", **line})
        raise SystemExit(f"{label}: the logits with the flash kernel "
                         f"disagree with the plain attention's "
                         f"({TOLERANCES['lm_bf16']}; max abs diff {diff}, "
                         f"{share} of the limit)")
    return launches, got, line


def moe_phase(torch, np, emit, smi_line, device="cuda") -> dict:
    """Phase 11: qwen3-moe-30b-a3b at full width, MOE_LAYERS of its 48
    layers (bf16, the flash kernel, seed 0): ``forward`` of MOE_BATCH x
    MOE_SEQ tokens against the plain attention's with the same routing
    (``lm_bf16``; ``lm_forward_pair``), the share of token-slots dropped at
    capacity factor 1.25 and those the plain forward's own routing sends
    elsewhere; ``prefill`` of those
    tokens, its last logits against the forward's (same groups, so the
    same routing); MOE_DECODE teacher-forced ``decode_step``s at batch
    MOE_DECODE_BATCH twice, bitwise, with their ms and aten calls a step;
    ``ServeEngine`` twice and across preemption (``engine_runs``); one
    layer's ``moe_block`` against ``moe_block_dense_ref`` at a capacity
    that drops nothing (``lm_bf16``), and one MoE block's ms beside one
    attention layer's.  Then llama4-scout-17b-a16e (top-1 and the shared
    expert) at full width, SCOUT_LAYERS of 48: ``forward`` of 1 x
    SCOUT_SEQ tokens, kernel against plain.  Returns the flash launches of
    the forwards and the prefill."""
    import dataclasses
    import importlib
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.models import counting, transformer
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import attention_block

    fmod = importlib.import_module("repro_torch.kernels.flash_attention")
    bf16 = torch.bfloat16
    t_phase = time.perf_counter()
    emit({"phase": "moe", "nvidia_smi": smi_line})
    published = get_config(MOE_ARCH)
    cfg = dataclasses.replace(published, num_layers=MOE_LAYERS,
                              use_pallas_attention=True)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    vocab = cfg.vocab_size
    toks = torch.from_numpy(np.random.default_rng(42).integers(
        0, vocab, (MOE_BATCH, MOE_SEQ))).to(device)

    # the forward, kernel against plain attention (routing pinned)
    fwd_launches, logits, line = lm_forward_pair(
        torch, emit, fmod, cfg, params, "qwen3_moe_forward", toks,
        published=published.num_layers, smi_line=smi_line)

    # prefill: its last logits against the forward's
    zero_flash(fmod)
    first, cache = transformer.prefill(cfg, params, toks, MOE_SEQ)
    torch.cuda.synchronize()
    prefill_launches = fmod.flash_attention.launches
    ok, prefill_diff = agree(torch, first[:, :vocab], logits[:, -1, :vocab],
                             "lm_bf16")
    prefill_share = scale_share(torch, first[:, :vocab],
                                logits[:, -1, :vocab], "lm_bf16")
    del first, cache, logits
    if prefill_launches != cfg.num_layers or not ok:
        raise SystemExit(f"moe: prefill launched {prefill_launches} flash "
                         f"kernels, its logits {prefill_share} of the "
                         f"lm_bf16 limit from the forward's")
    forward_ms = median_ms(torch, lambda: transformer.forward(
        cfg, params, toks), reps=3)
    prefill_ms = median_ms(torch, lambda: transformer.prefill(
        cfg, params, toks, MOE_SEQ), reps=3)
    emit({"phase": "moe", **line,
          "capacity": moe_mod.expert_capacity(cfg, cfg.moe_group_size),
          "prefill_flash_attention_launches": prefill_launches,
          "prefill_max_abs_diff_vs_forward": prefill_diff,
          "prefill_limit_share": prefill_share, "forward_ms": forward_ms,
          "forward_tokens_per_s": MOE_BATCH * MOE_SEQ / forward_ms * 1e3,
          "prefill_ms": prefill_ms,
          "prefill_tokens_per_s": MOE_BATCH * MOE_SEQ / prefill_ms * 1e3,
          "params": counting.param_count(cfg),
          "active_params": counting.active_param_count(cfg),
          "init_s": init_s})

    # teacher-forced decode at batch MOE_DECODE_BATCH, twice, bitwise
    dtoks = torch.from_numpy(np.random.default_rng(5).integers(
        0, vocab, (MOE_DECODE_BATCH, MOE_DECODE))).to(device)

    def decode_run():
        c = transformer.init_cache(cfg, MOE_DECODE_BATCH, MOE_DECODE,
                                   device=device)
        out, host = [], 0.0
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        for pos in range(MOE_DECODE):
            t = time.perf_counter()
            lg, c = transformer.decode_step(cfg, params, c, dtoks[:, pos],
                                            pos)
            host += time.perf_counter() - t
            out.append(lg)
        ev1.record()
        torch.cuda.synchronize()
        return (torch.stack(out, 1), ev0.elapsed_time(ev1) / MOE_DECODE,
                host / MOE_DECODE * 1e3)

    d1, decode_ms, decode_host_ms = decode_run()
    d2, decode_ms_2, _ = decode_run()
    if not torch.equal(d1, d2) or not bool(torch.isfinite(d1).all()):
        raise SystemExit("moe: teacher-forced decode gave other logits on a "
                         "second run (or non-finite ones)")
    del d1, d2
    c0 = transformer.init_cache(cfg, MOE_DECODE_BATCH, MOE_DECODE,
                                device=device)
    decode_aten = aten_calls(torch, lambda: transformer.decode_step(
        cfg, params, c0, dtoks[:, 0], 0))
    del c0
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        engine = engine_runs(torch, cfg, params,
                             engine_requests(np, MOE_ARCH, vocab), Path(tmp))
    emit({"phase": "moe", "part": "qwen3_moe_decode",
          "batch": MOE_DECODE_BATCH, "steps": MOE_DECODE,
          "decode_capacity": moe_mod.expert_capacity(cfg, MOE_DECODE_BATCH),
          "bitwise_equal_across_runs": True, "decode_ms_per_step": decode_ms,
          "decode_ms_per_step_second_run": decode_ms_2,
          "decode_host_ms_per_step": decode_host_ms,
          "aten_calls_per_step": decode_aten, "nvidia_smi": smi_line})
    emit({"phase": "moe", "part": "engine", **engine,
          "nvidia_smi": smi_line})

    # one layer's block: against the every-expert reference where nothing
    # drops; then its time beside one attention layer's
    pl0 = transformer._layer(params["layers"], 0)
    nodrop = dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.experts_per_tok)
    if moe_mod.expert_capacity(nodrop, cfg.moe_group_size) \
            < cfg.moe_group_size:
        raise SystemExit("moe: the no-drop capacity is below the group")
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, MOE_DENSE_REF_TOKENS, cfg.d_model))).to(device, bf16)
    y = moe_mod.moe_block(nodrop, pl0["moe"], x)
    yd = moe_mod.moe_block_dense_ref(nodrop, pl0["moe"], x)
    ok, ref_diff = agree(torch, y, yd, "lm_bf16")
    ref_share = scale_share(torch, y, yd, "lm_bf16")
    if not ok:
        raise SystemExit(f"moe: moe_block disagrees with "
                         f"moe_block_dense_ref where nothing drops "
                         f"({ref_share} of the lm_bf16 limit)")
    del x, y, yd
    h = torch.from_numpy(np.random.default_rng(4).normal(
        size=(MOE_BATCH, MOE_SEQ, cfg.d_model))).to(device, bf16)
    positions = torch.arange(MOE_SEQ, device=h.device).expand(MOE_BATCH,
                                                              MOE_SEQ)
    block_ms = median_ms(torch, lambda: moe_mod.moe_block(cfg, pl0["moe"], h),
                         reps=3)
    attn_ms = median_ms(torch, lambda: attention_block(cfg, pl0["attn"], h,
                                                       positions), reps=3)
    emit({"phase": "moe", "part": "qwen3_moe_block",
          "dense_ref_tokens": MOE_DENSE_REF_TOKENS,
          "dense_ref_max_abs_diff": ref_diff, "dense_ref_limit_share":
          ref_share, "tolerance": TOLERANCES["lm_bf16"],
          "moe_block_ms": block_ms, "attention_layer_ms": attn_ms,
          "shape": [MOE_BATCH, MOE_SEQ, cfg.d_model],
          "nvidia_smi": smi_line})
    del params, toks, dtoks, h, pl0
    torch.cuda.empty_cache()

    # llama4-scout: top-1 and the shared expert
    published = get_config(SCOUT_ARCH)
    scfg = dataclasses.replace(published, num_layers=SCOUT_LAYERS,
                               use_pallas_attention=True)
    sparams = transformer.init_params(scfg, seed=0, device=device)
    stoks = torch.from_numpy(np.random.default_rng(42).integers(
        0, scfg.vocab_size, (1, SCOUT_SEQ))).to(device)
    scout_launches, slog, sline = lm_forward_pair(
        torch, emit, fmod, scfg, sparams, "llama4_scout_forward", stoks,
        published=published.num_layers, smi_line=smi_line)
    del slog
    scout_ms = median_ms(torch, lambda: transformer.forward(
        scfg, sparams, stoks), reps=3)
    emit({"phase": "moe", **sline, "forward_ms": scout_ms,
          "forward_tokens_per_s": SCOUT_SEQ / scout_ms * 1e3,
          "params": counting.param_count(scfg)})
    del sparams, stoks
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    emit({"phase": "moe", "seconds": seconds, "all_agree": True,
          "nvidia_smi": smi_line})
    return {"flash_attention": fwd_launches + prefill_launches
            + scout_launches, "seconds": seconds}


def vlm_phase(torch, np, emit, smi_line, device="cuda") -> dict:
    """Phase 12: internvl2-26b at full width, VLM_LAYERS of its 48 layers
    (bf16, the flash kernel, seed 0), its 256 patch embeddings (seeded,
    at the token embeddings' scale: the vision frontend is a stub in both
    packages) before VLM_TEXT tokens, batch VLM_BATCH: ``forward`` and
    ``loss_fn`` with the kernel against the plain attention (``lm_bf16``).
    Returns their flash launches."""
    import dataclasses
    import importlib

    from repro_torch.configs import get_config
    from repro_torch.models import counting, transformer

    fmod = importlib.import_module("repro_torch.kernels.flash_attention")
    t_phase = time.perf_counter()
    published = get_config(VLM_ARCH)
    cfg = dataclasses.replace(published, num_layers=VLM_LAYERS,
                              use_pallas_attention=True)
    params = transformer.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(42)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (VLM_BATCH, VLM_TEXT))).to(device)
    patches = torch.from_numpy(rng.normal(
        size=(VLM_BATCH, cfg.num_patches, cfg.d_model)) * 0.02).to(
            device, torch.bfloat16)
    fwd_launches, logits, line = lm_forward_pair(
        torch, emit, fmod, cfg, params, "internvl2_forward", toks, patches,
        published=published.num_layers, smi_line=smi_line)
    if logits.shape[1] != cfg.num_patches + VLM_TEXT:
        raise SystemExit(f"vlm: logits {tuple(logits.shape)}")
    del logits
    batch = {"tokens": toks, "labels": toks, "patches": patches}
    with torch.no_grad():
        zero_flash(fmod)
        loss = transformer.loss_fn(cfg, params, batch)
        torch.cuda.synchronize()
        loss_launches = fmod.flash_attention.launches
        plain = transformer.loss_fn(
            dataclasses.replace(cfg, use_pallas_attention=False), params,
            batch)
    ok, loss_diff = agree(torch, loss, plain, "lm_bf16")
    if not ok or loss_launches != cfg.num_layers:
        raise SystemExit(f"vlm: loss_fn {float(loss)} with the kernel "
                         f"({loss_launches} launches) against "
                         f"{float(plain)} with the plain attention "
                         f"({TOLERANCES['lm_bf16']})")
    forward_ms = median_ms(torch, lambda: transformer.forward(
        cfg, params, toks, patches), reps=3)
    with torch.no_grad():
        loss_ms = median_ms(torch, lambda: transformer.loss_fn(
            cfg, params, batch), reps=3)
    seq = cfg.num_patches + VLM_TEXT
    emit({"phase": "vlm", **line, "forward_ms": forward_ms,
          "forward_tokens_per_s": VLM_BATCH * seq / forward_ms * 1e3,
          "loss": float(loss), "loss_plain_attention": float(plain),
          "loss_abs_diff": loss_diff, "loss_flash_attention_launches":
          loss_launches, "loss_fn_ms": loss_ms,
          "params": counting.param_count(cfg),
          "seconds": time.perf_counter() - t_phase})
    del params, toks, patches, batch
    torch.cuda.empty_cache()
    return {"flash_attention": fwd_launches + loss_launches}


def grad_rel(torch, got: dict, want: dict) -> dict:
    """||got - want|| / ||want|| per dotted leaf name (in f32); inf where
    either gradient is not finite."""
    out = {}

    def walk(g, w, pre):
        for k in sorted(w):
            if isinstance(w[k], dict):
                walk(g[k], w[k], f"{pre}{k}.")
                continue
            a, b = g[k].float(), w[k].float()
            rel = float((a - b).norm()) / max(float(b.norm()), 1e-30)
            finite = bool(torch.isfinite(a).all() and torch.isfinite(b).all())
            out[f"{pre}{k}"] = rel if finite else float("inf")
    walk(got, want, "")
    return out


def microbatched_part(torch, np, emit, smi_line, device="cuda") -> int:
    """Part of phase 13: ``launch.train.train_microbatched`` on the card.
    qwen3-0.6b at full width and LM_TRAIN_RESUME_LAYERS layers (flash
    kernel, remat "full"), LM_MB_STEPS steps at LM_TRAIN_BATCH x
    LM_TRAIN_SEQ in LM_MB_MICROBATCHES microbatches: one uninterrupted run,
    then one failed at LM_MB_FAIL_AT and resumed.  The resumed run must run
    exactly one microbatch, leave the cursor at the end of the last step
    and end on the uninterrupted run's parameter and optimizer files, byte
    for byte.  Step 0's mean accumulated gradient (what the trainer hands
    its optimizer) is held against one gradient of the whole batch at the
    same parameters, every leaf within GRAD_REL.  Prints ms a microbatch,
    the accumulator commit's s a microbatch and the flash launches (each
    microbatch: one a layer in the forward and one in the remat
    recompute, all on wgmma).  Returns the flash launches."""
    import dataclasses
    import filecmp
    import importlib
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import train as trainer

    flash = importlib.import_module(
        "repro_torch.kernels.flash_attention").flash_attention
    cfg = dataclasses.replace(get_config(LM_ARCH), use_pallas_attention=True,
                              num_layers=LM_TRAIN_RESUME_LAYERS)
    real_grad, real_store = trainer.make_grad_fn, trainer.SlotStore
    real_adamw = trainer.adamw
    mbs, commits, first_update = [], [], {}

    def timed_grad(cfg_, api):
        grad_fn = real_grad(cfg_, api)

        def timed(params, batch):
            torch.cuda.synchronize()
            f0 = flash.launches
            w0 = flash.launches_by_path["wgmma"]
            t0 = time.perf_counter()
            out = grad_fn(params, batch)
            torch.cuda.synchronize()
            mbs.append({"ms": (time.perf_counter() - t0) * 1e3,
                        "flash_attention_launches": flash.launches - f0,
                        "wgmma_launches": flash.launches_by_path["wgmma"]
                        - w0, "batch": batch})
            return out
        return timed

    class TimedStore(real_store):
        def save(self, tree, meta=None):
            t0 = time.perf_counter()
            slot = super().save(tree, meta)
            if self.root.name == "accum":
                commits.append(time.perf_counter() - t0)
            return slot

    def recording_adamw(*a, **kw):
        opt = real_adamw(*a, **kw)

        def update(grads, state, params):
            if not first_update:              # step 0 of the first run
                first_update.update(grads=grads, params=params)
            return opt.update(grads, state, params)
        return type(opt)(opt.init, update)

    def front_files(root):
        store = real_store(root / "state")
        m = store.manifest()
        return store.root / m["slot"], m

    kw = dict(steps=LM_MB_STEPS, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
              microbatches=LM_MB_MICROBATCHES, device=device)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    trainer.make_grad_fn, trainer.SlotStore, trainer.adamw = \
        timed_grad, TimedStore, recording_adamw
    try:
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            tmp = Path(tmp)
            flash.launches = 0                # zero just before the path
            full = trainer.train_microbatched(cfg, ckpt_dir=str(tmp / "a"),
                                              **kw)
            run_mbs, run_commits = list(mbs), list(commits)
            try:
                trainer.train_microbatched(cfg, ckpt_dir=str(tmp / "b"),
                                           fail_at=LM_MB_FAIL_AT, **kw)
            except trainer.SimulatedFailure:
                pass
            else:
                raise SystemExit(f"train: the microbatched run was not "
                                 f"failed at {LM_MB_FAIL_AT}")
            failed_cursor = trainer.Cursor(tmp / "b" / "cursor.json").read()
            before = len(mbs)
            resumed = trainer.train_microbatched(cfg,
                                                 ckpt_dir=str(tmp / "b"),
                                                 **kw)
            launches = flash.launches         # read just after
            rerun = len(mbs) - before
            cursor = trainer.Cursor(tmp / "b" / "cursor.json").read()
            (da, ma), (db, mb) = front_files(tmp / "a"), front_files(tmp / "b")
            same = ma["meta"] == mb["meta"] and ma["leaves"] == mb["leaves"] \
                and ma["dtypes"] == mb["dtypes"] and all(
                    filecmp.cmp(da / n, db / n, shallow=False)
                    for n in ma["leaves"])
            astore = real_store(tmp / "a" / "accum")
            am = astore.manifest()
            accum_bytes = sum((astore.root / am["slot"] / n).stat().st_size
                              for n in am["leaves"])
    finally:
        trainer.make_grad_fn, trainer.SlotStore, trainer.adamw = \
            real_grad, real_store, real_adamw
    per_mb = 2 * cfg.num_layers
    if any(m["flash_attention_launches"] != per_mb
           or m["wgmma_launches"] != per_mb for m in mbs):
        raise SystemExit(f"train: microbatched flash launches "
                         f"{[m['flash_attention_launches'] for m in mbs]}, "
                         f"not {per_mb} a microbatch on wgmma")
    want_cursor = {"step": LM_MB_STEPS, "mb": 0}
    if not same or rerun != 1 or resumed.losses != full.losses[-1:] \
            or {k: cursor.get(k) for k in want_cursor} != want_cursor:
        raise SystemExit(f"train: the microbatched run failed at "
                         f"{LM_MB_FAIL_AT} and resumed ran {rerun} "
                         f"microbatches (cursor {cursor}, files equal: "
                         f"{same}, losses {resumed.losses} against "
                         f"{full.losses})")

    # step 0's mean accumulated gradient against the whole batch's
    api = trainer.get_model(cfg)
    step0 = [m["batch"] for m in run_mbs[:LM_MB_MICROBATCHES]]
    whole = {k: torch.cat([b[k] for b in step0]) for k in step0[0]}
    loss_w, g_whole = real_grad(cfg, api)(first_update["params"], whole)
    rel = grad_rel(torch, first_update["grads"], g_whole)
    worst = max(rel, key=rel.get)
    for m in mbs:
        del m["batch"]
    tokens = LM_TRAIN_BATCH // LM_MB_MICROBATCHES * LM_TRAIN_SEQ
    emit({"phase": "train", "part": "qwen3_microbatched", "arch": LM_ARCH,
          "layers": cfg.num_layers, "reduced": f"{cfg.num_layers} of "
          f"{get_config(LM_ARCH).num_layers} layers; full width",
          "steps": LM_MB_STEPS, "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
          "microbatches": LM_MB_MICROBATCHES, "losses": full.losses,
          "microbatch_ms": [m["ms"] for m in run_mbs],
          "tokens_per_s": [tokens / m["ms"] * 1e3 for m in run_mbs],
          "accumulator_commit_s": run_commits,
          "accumulator_bytes": accum_bytes,
          "flash_attention_launches": launches,
          "flash_attention_launches_per_microbatch":
              [m["flash_attention_launches"] for m in mbs],
          "failed_at": list(LM_MB_FAIL_AT), "failed_cursor": failed_cursor,
          "resumed_microbatches": rerun, "final_cursor": cursor,
          "resume_bitwise_equal": True, "loss_whole_batch": float(loss_w),
          "grad_rel_max": rel[worst], "grad_rel_worst_leaf": worst,
          "limit": GRAD_REL, "wall_s": full.wall_s, "nvidia_smi": smi_line})
    if rel[worst] > GRAD_REL:
        raise SystemExit(f"train: step 0's accumulated gradient is "
                         f"{rel[worst]} of the whole batch's at {worst} "
                         f"(limit {GRAD_REL})")
    del first_update["grads"], first_update["params"], g_whole, whole
    torch.cuda.empty_cache()
    return launches


def train_phase(torch, np, emit, smi_line, device="cuda") -> dict:
    """Phase 13: training on the card.  qwen3-0.6b as published (bf16, the
    flash kernel, remat "full"): ``launch.train.train`` for LM_TRAIN_STEPS
    steps at LM_TRAIN_BATCH x LM_TRAIN_SEQ, a checkpoint every
    LM_TRAIN_CKPT steps, the flash launches zeroed just before and read
    just after (each step: one a layer in the forward and one in the
    remat recompute); each step's loss, ms (the gradient's and the
    update's), flash launches and peak device memory over what was
    allocated when the phase began, each checkpoint write's s.  At full
    width and LM_TRAIN_RESUME_LAYERS layers, a run failing at
    LM_TRAIN_FAIL_AT and resumed must end on an uninterrupted run's
    parameter and optimizer files at that depth, byte for byte.  One ``loss_fn``
    backward with the kernel against the plain attention: every leaf's
    ||g_kernel - g_plain|| / ||g_plain|| <= GRAD_REL.  Then mamba2-370m as
    published: SSM_TRAIN_STEPS steps (``ssd_intra`` counted the same way)
    and its gradient against the plain cell's.  Returns the launches of
    the two training runs."""
    import dataclasses
    import filecmp
    import importlib
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data import token_batches
    from repro_torch.kernels import ref
    from repro_torch.launch import train as trainer
    from repro_torch.models import get_model, mamba2

    fmod = importlib.import_module("repro_torch.kernels.flash_attention")
    smod = importlib.import_module("repro_torch.kernels.ssd_intra")
    flash, ssd = fmod.flash_attention, smod.ssd_intra
    t_phase = time.perf_counter()
    # what is allocated before a run (the earlier phases' and parts' own),
    # left out of its steps' peaks
    base = {"bytes": torch.cuda.memory_allocated()}
    emit({"phase": "train", "nvidia_smi": smi_line,
          "device_bytes_at_start": base["bytes"]})
    steps, saves, grad_ms = [], [], []
    real_make, real_store = trainer.make_train_step, trainer.SlotStore
    real_grad = trainer.make_grad_fn

    def timed_grad(cfg_, api):
        grad_fn = real_grad(cfg_, api)

        def timed(params, batch):
            t0 = time.perf_counter()
            out = grad_fn(params, batch)
            torch.cuda.synchronize()
            grad_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    def timed_make(cfg_, api, opt):
        step = real_make(cfg_, api, opt)

        def timed(params, opt_state, batch):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            f0, s0 = flash.launches, ssd.launches
            t0 = time.perf_counter()
            out = step(params, opt_state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            steps.append({"loss": float(out[2]), "step_ms": ms,
                          "grad_ms": grad_ms[-1],
                          "update_ms": ms - grad_ms[-1],
                          "flash_attention_launches": flash.launches - f0,
                          "ssd_intra_launches": ssd.launches - s0,
                          "peak_bytes": torch.cuda.max_memory_allocated()
                          - base["bytes"]})
            return out
        return timed

    def patch(on: bool):
        trainer.make_train_step, trainer.make_grad_fn, trainer.SlotStore = \
            (timed_make, timed_grad, TimedStore) if on else \
            (real_make, real_grad, real_store)

    class TimedStore(real_store):
        def save(self, tree, meta=None):
            t0 = time.perf_counter()
            slot = super().save(tree, meta)
            saves.append(time.perf_counter() - t0)
            return slot

    def front_files(root):
        store = real_store(root / "state")
        m = store.manifest()
        return store.root / m["slot"], m

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    cfg = dataclasses.replace(get_config(LM_ARCH), use_pallas_attention=True)
    free = shutil.disk_usage(build).free      # the A/B slots of two runs
    kw = dict(steps=LM_TRAIN_STEPS, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
              ckpt_interval=LM_TRAIN_CKPT, log_every=0, device=device)
    patch(True)
    try:
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            tmp = Path(tmp)
            flash.launches = 0                # zero just before the path
            res = trainer.train(cfg, ckpt_dir=str(tmp / "a"), **kw)
            train_launches = flash.launches   # read just after
            run_steps, run_saves = list(steps), list(saves)
            da, ma = front_files(tmp / "a")
            ckpt_bytes = sum((da / n).stat().st_size for n in ma["leaves"])
            shutil.rmtree(tmp / "a")
            # the resume check at a cut depth: uninterrupted, then failed
            # and resumed
            rcfg = dataclasses.replace(cfg, num_layers=LM_TRAIN_RESUME_LAYERS)
            t0 = time.perf_counter()
            full = trainer.train(rcfg, ckpt_dir=str(tmp / "c"), **kw)
            try:
                trainer.train(rcfg, ckpt_dir=str(tmp / "b"),
                              fail_at_step=LM_TRAIN_FAIL_AT, **kw)
            except trainer.SimulatedFailure:
                pass
            else:
                raise SystemExit("train: the run was not failed at step "
                                 f"{LM_TRAIN_FAIL_AT}")
            resumed = trainer.train(rcfg, ckpt_dir=str(tmp / "b"), **kw)
            resume_s = time.perf_counter() - t0
            (dc, mc), (db, mb) = front_files(tmp / "c"), front_files(tmp / "b")
            same = mc["meta"] == mb["meta"] and mc["leaves"] == mb["leaves"] \
                and mc["dtypes"] == mb["dtypes"] and all(
                    filecmp.cmp(dc / n, db / n, shallow=False)
                    for n in mc["leaves"])
            resume_bytes = sum((dc / n).stat().st_size for n in mc["leaves"])
            resume_saves = saves[len(run_saves):]
    finally:
        patch(False)
    resume_start = LM_TRAIN_FAIL_AT // LM_TRAIN_CKPT * LM_TRAIN_CKPT
    if not all(np.isfinite(res.losses)):
        raise SystemExit(f"train: {LM_ARCH}'s losses {res.losses}")
    if not same or resumed.losses != full.losses[resume_start:] \
            or resumed.steps_run != LM_TRAIN_STEPS - resume_start:
        raise SystemExit(f"train: the run failed at step "
                         f"{LM_TRAIN_FAIL_AT} and resumed differs from the "
                         f"uninterrupted one (files equal: {same}; losses "
                         f"{resumed.losses} against {full.losses})")
    per_step = 2 * cfg.num_layers
    if any(s["flash_attention_launches"] != per_step for s in run_steps):
        raise SystemExit(f"train: flash launches a step "
                         f"{[s['flash_attention_launches'] for s in run_steps]}"
                         f", not {per_step} (forward and remat recompute)")
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    emit({"phase": "train", "part": "qwen3_train", "arch": LM_ARCH,
          "layers": cfg.num_layers, "disk_free_bytes": free,
          "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ, "remat": cfg.remat,
          "steps": run_steps, "losses": res.losses,
          "tokens_per_s": [tokens / s["step_ms"] * 1e3 for s in run_steps],
          "checkpoint_write_s": run_saves, "checkpoint_bytes": ckpt_bytes,
          "flash_attention_launches": train_launches,
          "resume_check_layers": LM_TRAIN_RESUME_LAYERS,
          "resume_check_checkpoint_bytes": resume_bytes,
          "resume_check_write_s": resume_saves, "resume_check_s": resume_s,
          "resumed_at_step": resume_start, "resumed_steps":
          resumed.steps_run, "resume_bitwise_equal": True,
          "wall_s": res.wall_s, "nvidia_smi": smi_line})

    # the gradient through the kernel against the plain attention's
    api = get_model(cfg)
    params = api.init_params(cfg, seed=0, device=device)
    batch = trainer._batch(next(token_batches(cfg.vocab_size,
                                              LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                              1, seed=0)), params[
                                                  "embed"].device)
    f0 = flash.launches
    loss_k, g_k = trainer.make_grad_fn(cfg, api)(params, batch)
    torch.cuda.synchronize()
    grad_launches = flash.launches - f0
    loss_p, g_p = trainer.make_grad_fn(dataclasses.replace(
        cfg, use_pallas_attention=False), api)(params, batch)
    rel = grad_rel(torch, g_k, g_p)
    worst = max(rel, key=rel.get)
    emit({"phase": "train", "part": "qwen3_gradient", "layers":
          cfg.num_layers, "loss_kernel": float(loss_k), "loss_plain":
          float(loss_p), "flash_attention_launches": grad_launches,
          "grad_rel_max": rel[worst], "grad_rel_worst_leaf": worst,
          "grad_rel_attention": {k: v for k, v in rel.items()
                                 if ".attn." in k},
          "limit": GRAD_REL, "nvidia_smi": smi_line})
    if rel[worst] > GRAD_REL or grad_launches != 2 * cfg.num_layers:
        raise SystemExit(f"train: the gradient through the flash kernel is "
                         f"{rel[worst]} of the plain attention's at {worst} "
                         f"(limit {GRAD_REL}; {grad_launches} launches)")
    del params, g_k, g_p, batch
    torch.cuda.empty_cache()
    mb_launches = microbatched_part(torch, np, emit, smi_line, device)

    # mamba2-370m: training through ssd_intra, then its gradient
    mcfg = get_config(SSM_ARCH)
    steps.clear()
    saves.clear()
    base["bytes"] = torch.cuda.memory_allocated()
    patch(True)
    try:
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            ssd.launches = 0                  # zero just before the path
            mres = trainer.train(mcfg, steps=SSM_TRAIN_STEPS,
                                 batch=SSM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
                                 ckpt_dir=tmp, ckpt_interval=SSM_TRAIN_STEPS,
                                 log_every=0, device=device)
            ssm_launches = ssd.launches       # read just after
    finally:
        patch(False)
    ssm_steps, ssm_saves = list(steps), list(saves)
    if not all(np.isfinite(mres.losses)):
        raise SystemExit(f"train: {SSM_ARCH}'s losses {mres.losses}")
    if any(s["ssd_intra_launches"] != 2 * mcfg.num_layers
           for s in ssm_steps):
        raise SystemExit(f"train: ssd_intra launches a step "
                         f"{[s['ssd_intra_launches'] for s in ssm_steps]}, "
                         f"not {2 * mcfg.num_layers}")
    mapi = get_model(mcfg)
    mparams = mapi.init_params(mcfg, seed=0, device=device)
    mbatch = trainer._batch(next(token_batches(
        mcfg.vocab_size, SSM_TRAIN_BATCH, LM_TRAIN_SEQ, 1, seed=0)),
        mparams["embed"].device)
    s0 = ssd.launches
    mloss_k, mg_k = trainer.make_grad_fn(mcfg, mapi)(mparams, mbatch)
    torch.cuda.synchronize()
    mgrad_launches = ssd.launches - s0
    kernel = mamba2.ssd_intra
    mamba2.ssd_intra = ref.ssd_intra_ref          # the comparison run only
    try:
        mloss_p, mg_p = trainer.make_grad_fn(mcfg, mapi)(mparams, mbatch)
    finally:
        mamba2.ssd_intra = kernel
    mrel = grad_rel(torch, mg_k, mg_p)
    mworst = max(mrel, key=mrel.get)
    emit({"phase": "train", "part": "mamba2_train", "arch": SSM_ARCH,
          "layers": mcfg.num_layers, "batch": SSM_TRAIN_BATCH,
          "seq": LM_TRAIN_SEQ, "steps": ssm_steps, "losses": mres.losses,
          "tokens_per_s": [SSM_TRAIN_BATCH * LM_TRAIN_SEQ / s["step_ms"]
                           * 1e3 for s in ssm_steps],
          "checkpoint_write_s": ssm_saves, "ssd_intra_launches":
          ssm_launches, "grad_ssd_intra_launches": mgrad_launches,
          "loss_kernel": float(mloss_k), "loss_plain_cell": float(mloss_p),
          "grad_rel_max": mrel[mworst], "grad_rel_worst_leaf": mworst,
          "grad_rel": mrel, "limit": GRAD_REL, "nvidia_smi": smi_line})
    if mrel[mworst] > GRAD_REL:
        raise SystemExit(f"train: {SSM_ARCH}'s gradient through ssd_intra "
                         f"is {mrel[mworst]} of the plain cell's at "
                         f"{mworst} (limit {GRAD_REL})")
    del mparams, mg_k, mg_p, mbatch
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    emit({"phase": "train", "seconds": seconds, "all_agree": True,
          "nvidia_smi": smi_line})
    return {"flash_attention": train_launches + mb_launches,
            "ssd_intra": ssm_launches, "seconds": seconds}


#: Phases 14-15 (``hybrid``, ``encdec``).  zamba2-7b at full width (d_model
#: 3,584, 32 heads of 112, d_ff 14,336, ssm_state 64, 112 SSD heads of 64,
#: bf16), its depth cut to HYBRID_LAYERS of 81 (two super-blocks of six
#: mamba blocks and the shared block, then the published tail of 3; no
#: kernel shape depends on depth): forward over LM_BATCH x LM_SEQ tokens,
#: HYBRID_DECODE teacher-forced decode steps, its engine (ENGINE_RUNS), one
#: ``loss_fn`` backward over LM_BATCH x HYBRID_GRAD_SEQ at HYBRID_GRAD_LAYERS
#: (one super-block and one trailing block).  whisper-small as published
#: (12 + 12 layers): forward over ENCDEC_BATCH x (1,500 frames +
#: ENCDEC_TEXT tokens, whisper's decoder context), ENCDEC_DECODE decode
#: steps after ``prefill_cross``, one ``loss_fn`` backward.
HYBRID_ARCH, HYBRID_LAYERS, HYBRID_DECODE = "zamba2-7b", 15, 32
HYBRID_GRAD_LAYERS, HYBRID_GRAD_SEQ = 7, 1024
ENGINE_RUNS[HYBRID_ARCH] = (4, 64, 32)
ENCDEC_ARCH, ENCDEC_BATCH, ENCDEC_TEXT, ENCDEC_DECODE = \
    "whisper-small", 2, 448, 32


def zero_ssd(smod) -> None:
    smod.ssd_intra.launches = 0
    for p in smod.ssd_intra.launches_by_path:
        smod.ssd_intra.launches_by_path[p] = 0


def flash_alone(torch, np, fmod, rng, bh: int, sq: int, sk: int, d: int,
                causal: bool, label: str) -> dict:
    """The bf16 attention kernel alone on seeded (bh, sq, d) / (bh, sk, d)
    operands: held against the plain version at its own tiles
    (``attn_bf16``), timed beside the plain version, one
    ``scaled_dot_product_attention`` on the same operands, its bound (the
    products, at half the pairs when causal, at the bf16 peak; each
    operand read once and the output written once) and the mma.sync
    kernel by name (``previous_ms``)."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16

    def dev(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(bf16).cuda()

    q, k, v = dev((bh, sq, d)), dev((bh, sk, d)), dev((bh, sk, d))
    path = fmod.attention_path(q, k, v)
    got = fmod.flash_attention(q, k, v, causal=causal)
    bq, bk = fmod.kernel_tiles(path)
    want = fmod.flash_attention_plain(q, k, v, causal=causal, bq=bq, bk=bk)
    ok, diff = agree(torch, got, want, "attn_bf16")
    share = limit_share(torch, got, want, "attn_bf16")
    del got, want
    if not ok:
        raise SystemExit(f"{label}: flash_attention ({bh}, {sq}, {d}) over "
                         f"{sk} keys ({path}) disagrees with the plain "
                         f"version ({TOLERANCES['attn_bf16']}; max abs diff "
                         f"{diff}, {share} of the limit)")
    pairs = sq * sk / 2 if causal else sq * sk
    flops = 4.0 * pairs * d * bh
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    q4, k4, v4 = (t.view(1, bh, -1, d) for t in (q, k, v))
    r = dict(
        path=path, causal=causal, max_abs_err=diff, limit_share=share,
        tolerance=TOLERANCES["attn_bf16"],
        ms=median_ms(torch, lambda: fmod.flash_attention(q, k, v,
                                                         causal=causal),
                     inner=INNER),
        plain_ms=median_ms(torch, lambda: fmod.flash_attention_plain(
            q, k, v, causal=causal, bq=bq, bk=bk), reps=3),
        library_ms=median_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal), inner=INNER),
        previous_ms=median_ms(torch, lambda: fmod.launch(
            q, k, v, "mma_sync", causal=causal), inner=INNER),
        flops=flops, bytes=nbytes,
        shape=f"q ({bh}, {sq}, {d}) bf16, k/v ({bh}, {sk}, {d}), "
              f"{'causal' if causal else 'non-causal'}")
    r["bound_ms"], r["bound_by"] = bound(flops, nbytes, PEAK_BF16_OPS)
    r["of_bound"] = r["bound_ms"] / r["ms"]
    return r


def ssd_alone(torch, np, smod, rng, bc: int, h: int, q: int, p: int, n: int,
              label: str) -> dict:
    """The SSD cell alone on seeded f32 inputs at (bc, h) cells of Q x N x
    P: held against the plain cell (``ssd``) and the f64 cell
    (``ssd_f64``), timed beside the plain cell and its bound (the 3xTF32
    products with G once a batch*chunk; each input read once and each
    output written once)."""
    from repro_torch.kernels import ref

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

    args = (dev(rng.normal(size=(bc, h, q, p))),
            dev(rng.normal(size=(bc, q, n))), dev(rng.normal(size=(bc, q, n))),
            dev(np.cumsum(-rng.uniform(0.005, 1.0, (bc, h, q)), axis=-1)))
    path = smod.ssd_path(*args)
    got = smod.ssd_intra(*args)
    want = ref.ssd_intra_ref(*args)
    exact = ref.ssd_intra_ref(*args, dtype=torch.float64)
    diff = share = 0.0
    for g, w, e in zip(got, want, exact):
        ok, d = agree(torch, g, w, "ssd")
        diff, share = max(diff, d), max(share, tf32x3_share(torch, g, w, e))
        if not ok or share > 1.0:
            raise SystemExit(f"{label}: ssd_intra at {bc} x {h} cells "
                             f"({path}) misses its rules ({TOLERANCES['ssd']};"
                             f" max abs diff {d}, {share} of the f64 limit)")
    del got, want, exact
    tri = q * (q + 1) // 2
    cells = bc * h
    flops = 2.0 * (bc * tri * n + cells * tri * p + cells * q * n * p)
    nbytes = 4 * (2 * cells * q * p + 2 * bc * q * n + cells * q
                  + cells * n * p)
    r = dict(
        path=path, max_abs_err=diff, f64_limit_share=share,
        tolerance=[TOLERANCES["ssd"], TOLERANCES["ssd_f64"]],
        plan={"heads_per_cta": smod.ssd_plan(bc, h, q, n)},
        ms=median_ms(torch, lambda: smod.ssd_intra(*args), inner=INNER),
        plain_ms=median_ms(torch, lambda: ref.ssd_intra_ref(*args), reps=3),
        library_ms=None, flops=flops, bytes=nbytes,
        shape=f"xdt ({bc}, {h}, {q}, {p}), bb/cc ({bc}, {q}, {n}) float32, "
              f"outputs f32")
    r["bound_ms"], r["bound_by"] = bound(3 * flops, nbytes, PEAK_TF32_OPS)
    r["of_bound"] = r["bound_ms"] / r["ms"]
    return r


@contextlib.contextmanager
def plain_cell(mamba2, ref):
    """The plain SSD cell in ``models.mamba2`` for the comparison runs
    inside the ``with`` block only."""
    kernel = mamba2.ssd_intra
    mamba2.ssd_intra = ref.ssd_intra_ref
    try:
        yield
    finally:
        mamba2.ssd_intra = kernel


def hybrid_phase(torch, np, emit, smi_line, device="cuda") -> dict:
    """Phase 14: zamba2-7b at full width, HYBRID_LAYERS of its 81 layers
    (bf16, the flash kernel, seed 0).  ``forward`` of LM_BATCH x LM_SEQ
    tokens with both kernels' launches zeroed just before and read just
    after (the shared block's attention, heads of 112, on ``wgmma``;
    one SSD cell a mamba block on wgmma, each launch held at once against
    the plain cell, ``ssd`` and ``ssd_f64``); the logits against the
    forward with the plain attention and the plain cell (``lm_bf16``);
    ms and tokens/s beside ``counting.model_flops``.  HYBRID_DECODE
    teacher-forced ``decode_step``s from an empty cache against a forward
    over those tokens (``ssm_decode_bf16``), ms and aten calls a step; its
    ``ServeEngine`` twice and across preemption (``engine_runs``); one
    ``loss_fn`` backward at HYBRID_GRAD_LAYERS over LM_BATCH x
    HYBRID_GRAD_SEQ through ``FlashAttentionFunction`` and
    ``SSDIntraFunction`` against the plain versions' (GRAD_REL a leaf).
    Then the attention kernel alone at the shared block's shape and the SSD
    cell at its 3,584 cells.  Returns the kernels' launches on the path."""
    import dataclasses
    import importlib
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.launch import train as trainer
    from repro_torch.models import counting, get_model, mamba2, zamba2

    fmod = importlib.import_module("repro_torch.kernels.flash_attention")
    smod = importlib.import_module("repro_torch.kernels.ssd_intra")
    flash, ssd = fmod.flash_attention, smod.ssd_intra
    t_phase = time.perf_counter()
    emit({"phase": "hybrid", "nvidia_smi": smi_line})
    published = get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(published, num_layers=HYBRID_LAYERS,
                              use_pallas_attention=True)
    a, n_super, trailing = zamba2._splits(cfg)
    reduced = (f"{HYBRID_LAYERS} of {published.num_layers} layers ({n_super} "
               f"super-blocks of {a} mamba blocks and the shared block, "
               f"then {trailing} trailing: the published tail); full width")
    t0 = time.perf_counter()
    params = zamba2.init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    vocab = cfg.vocab_size
    toks = torch.from_numpy(np.random.default_rng(42).integers(
        0, vocab, (LM_BATCH, LM_SEQ))).to(device)
    wrapper = mamba2.ssd_intra
    f64_share = cell_diff = 0.0

    def checked(*args):
        """The wrapper, each launch's outputs held at once against the
        plain cell on the same inputs (ssd and ssd_f64)."""
        nonlocal f64_share, cell_diff
        got = wrapper(*args)
        want = ref.ssd_intra_ref(*args)
        exact = ref.ssd_intra_ref(*args, dtype=torch.float64)
        for g, w, e in zip(got, want, exact):
            share = tf32x3_share(torch, g, w, e)
            ok, d = agree(torch, g, w, "ssd")
            f64_share, cell_diff = max(f64_share, share), max(cell_diff, d)
            if share > 1.0 or not ok:
                raise SystemExit(f"hybrid: an ssd_intra launch in "
                                 f"{HYBRID_ARCH}'s forward misses its rules "
                                 f"({TOLERANCES['ssd']}; max abs diff {d}, "
                                 f"{share} of the f64 limit)")
        return got

    zero_flash(fmod)                          # zero just before the path
    zero_ssd(smod)
    mamba2.ssd_intra = checked
    try:
        logits = zamba2.forward(cfg, params, toks)
        torch.cuda.synchronize()
    finally:
        mamba2.ssd_intra = wrapper
    fwd = {"flash_attention": flash.launches,  # read just after
           "ssd_intra": ssd.launches,
           "flash_attention_by_path": dict(flash.launches_by_path),
           "ssd_intra_by_path": dict(ssd.launches_by_path)}
    line = {"part": "zamba2_forward", "arch": HYBRID_ARCH,
            "layers": cfg.num_layers, "reduced": reduced, "batch": LM_BATCH,
            "seq": LM_SEQ, "hd": cfg.hd, "ssm_heads": cfg.ssm_heads,
            "launches": fwd, "nvidia_smi": smi_line}
    if fwd["flash_attention"] != n_super \
            or fwd["flash_attention_by_path"]["wgmma"] != n_super \
            or fwd["ssd_intra"] != cfg.num_layers \
            or fwd["ssd_intra_by_path"]["wgmma"] != cfg.num_layers:
        emit({"phase": "hybrid_failed", **line})
        raise SystemExit(f"hybrid: the forward launched {fwd}, not "
                         f"{n_super} flash_attention on wgmma and "
                         f"{cfg.num_layers} ssd_intra on wgmma")
    if logits.shape != (LM_BATCH, LM_SEQ, cfg.vocab_padded) \
            or logits.dtype != torch.float32:
        raise SystemExit(f"hybrid: logits {tuple(logits.shape)} "
                         f"{logits.dtype}")
    plain_cfg = dataclasses.replace(cfg, use_pallas_attention=False)
    with plain_cell(mamba2, ref):
        plain = zamba2.forward(plain_cfg, params, toks)
        torch.cuda.synchronize()
    # the forward's logits where the decode below is held against them
    want = logits[:, :HYBRID_DECODE, :vocab].clone()
    ok, diff = agree(torch, logits[..., :vocab], plain[..., :vocab],
                     "lm_bf16")
    share = scale_share(torch, logits[..., :vocab], plain[..., :vocab],
                        "lm_bf16")
    finite = bool(torch.isfinite(logits).all())
    del logits, plain
    if not ok or not finite:
        emit({"phase": "hybrid_failed", **line, "limit_share": share})
        raise SystemExit(f"hybrid: the logits with the kernels disagree "
                         f"with the plain path's ({TOLERANCES['lm_bf16']}; "
                         f"max abs diff {diff}, {share} of the limit)")
    forward_ms = median_ms(torch, lambda: zamba2.forward(cfg, params, toks),
                           reps=3)
    with plain_cell(mamba2, ref):
        plain_ms = median_ms(torch, lambda: zamba2.forward(plain_cfg, params,
                                                           toks), reps=1)
    tokens = LM_BATCH * LM_SEQ
    convention = counting.model_flops(cfg, tokens, "prefill")
    attn_flops = 2.0 * LM_SEQ * LM_SEQ * cfg.hd * cfg.num_heads * LM_BATCH \
        * n_super                             # causal half, QK^T and PV
    fwd_flops = convention - 2.0 * tokens * cfg.vocab_padded * cfg.d_model \
        + attn_flops
    emit({"phase": "hybrid", **line,
          "max_abs_diff_vs_plain": diff, "limit_share": share,
          "tolerance": TOLERANCES["lm_bf16"],
          "ssd_launches_max_abs_diff_vs_plain": cell_diff,
          "ssd_launches_f64_max_limit_share": f64_share,
          "forward_ms": forward_ms, "tokens_per_s": tokens / forward_ms
          * 1e3, "plain_forward_ms": plain_ms,
          "params": counting.param_count(cfg),
          "params_published": counting.param_count(published),
          "model_flops_2nd": convention, "forward_flops": fwd_flops,
          "forward_bound_ms": fwd_flops / PEAK_BF16_OPS * 1e3,
          "bound_by": "operations", "init_s": init_s})

    # teacher-forced decode from an empty cache against the forward's
    # logits at the same positions
    dtoks = toks[:, :HYBRID_DECODE]
    cache = zamba2.init_cache(cfg, LM_BATCH, HYBRID_DECODE, device=device)
    steps, host_s = [], 0.0
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    for pos in range(HYBRID_DECODE):
        t0 = time.perf_counter()
        lg, cache = zamba2.decode_step(cfg, params, cache, dtoks[:, pos], pos)
        host_s += time.perf_counter() - t0
        steps.append(lg[:, :vocab])
    ev1.record()
    torch.cuda.synchronize()
    got = torch.stack(steps, 1)
    ok, ddiff = agree(torch, got, want, "ssm_decode_bf16")
    dshare = scale_share(torch, got, want, "ssm_decode_bf16")
    if not ok:
        raise SystemExit(f"hybrid: decode disagrees with the forward "
                         f"({TOLERANCES['ssm_decode_bf16']}; max abs diff "
                         f"{ddiff}, {dshare} of the limit)")
    del got, want, steps
    c0 = zamba2.init_cache(cfg, LM_BATCH, HYBRID_DECODE, device=device)
    decode_aten = aten_calls(torch, lambda: zamba2.decode_step(
        cfg, params, c0, dtoks[:, 0], 0))
    del c0, cache
    emit({"phase": "hybrid", "part": "zamba2_decode", "steps":
          HYBRID_DECODE, "batch": LM_BATCH,
          "max_abs_diff_vs_forward": ddiff, "limit_share": dshare,
          "tolerance": TOLERANCES["ssm_decode_bf16"],
          "decode_ms_per_step": ev0.elapsed_time(ev1) / HYBRID_DECODE,
          "decode_host_ms_per_step": host_s / HYBRID_DECODE * 1e3,
          "aten_calls_per_step": decode_aten, "nvidia_smi": smi_line})

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        engine = engine_runs(torch, cfg, params,
                             engine_requests(np, HYBRID_ARCH, vocab),
                             Path(tmp))
    emit({"phase": "hybrid", "part": "engine", **engine,
          "nvidia_smi": smi_line})
    del params, toks, dtoks
    torch.cuda.empty_cache()

    # one loss_fn backward through both kernels against the plain versions
    gcfg = dataclasses.replace(cfg, num_layers=HYBRID_GRAD_LAYERS)
    api = get_model(gcfg)
    gparams = api.init_params(gcfg, seed=0, device=device)
    gt = torch.from_numpy(np.random.default_rng(3).integers(
        0, vocab, (LM_BATCH, HYBRID_GRAD_SEQ))).to(device)
    batch = {"tokens": gt, "labels": gt}
    zero_flash(fmod)
    zero_ssd(smod)
    loss_k, g_k = trainer.make_grad_fn(gcfg, api)(gparams, batch)
    torch.cuda.synchronize()
    grad = {"flash_attention": flash.launches, "ssd_intra": ssd.launches,
            "flash_attention_by_path": dict(flash.launches_by_path),
            "ssd_intra_by_path": dict(ssd.launches_by_path)}
    with plain_cell(mamba2, ref):
        loss_p, g_p = trainer.make_grad_fn(dataclasses.replace(
            gcfg, use_pallas_attention=False), api)(gparams, batch)
    rel = grad_rel(torch, g_k, g_p)
    worst = max(rel, key=rel.get)
    g_super = zamba2._splits(gcfg)[1]
    per = 2 if gcfg.remat == "full" else 1    # forward and remat recompute
    emit({"phase": "hybrid", "part": "zamba2_gradient",
          "layers": gcfg.num_layers, "batch": LM_BATCH,
          "seq": HYBRID_GRAD_SEQ, "remat": gcfg.remat,
          "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
          "launches": grad, "grad_rel_max": rel[worst],
          "grad_rel_worst_leaf": worst, "grad_rel_shared_attention": {
              k: v for k, v in rel.items() if "shared.attn." in k},
          "grad_rel_ssd": {k: v for k, v in rel.items()
                           if k.endswith(("A_log", "dt_bias"))},
          "limit": GRAD_REL, "nvidia_smi": smi_line})
    if rel[worst] > GRAD_REL or grad["flash_attention_by_path"][
            "wgmma"] != per * g_super or grad["ssd_intra_by_path"][
            "wgmma"] != per * gcfg.num_layers:
        raise SystemExit(f"hybrid: the gradient through the kernels is "
                         f"{rel[worst]} of the plain versions' at {worst} "
                         f"(limit {GRAD_REL}; launches {grad})")
    del gparams, g_k, g_p, batch, gt
    torch.cuda.empty_cache()

    # the kernels alone at the path's shapes
    rng = np.random.default_rng(11)
    attn = flash_alone(torch, np, fmod, rng, LM_BATCH * cfg.num_heads, LM_SEQ,
                       LM_SEQ, cfg.hd, True, "hybrid")
    if attn["path"] != "wgmma":
        raise SystemExit(f"hybrid: the shared block's attention takes the "
                         f"{attn['path']} kernel")
    cell = ssd_alone(torch, np, smod, rng, LM_BATCH * LM_SEQ // cfg.ssm_chunk,
                     cfg.ssm_heads, cfg.ssm_chunk, cfg.ssm_headdim,
                     cfg.ssm_state, "hybrid")
    if cell["path"] != "wgmma":
        raise SystemExit(f"hybrid: the SSD cell takes the {cell['path']} "
                         f"kernel")
    for name, r in (("flash_attention", attn), ("ssd_intra", cell)):
        emit({"phase": "hybrid", "part": "kernel_alone", "kernel": name, **r,
              "nvidia_smi": smi_line})
    seconds = time.perf_counter() - t_phase
    emit({"phase": "hybrid", "seconds": seconds, "all_agree": True,
          "nvidia_smi": smi_line})
    launches = {}
    for name in ("flash_attention", "ssd_intra"):
        launches[name] = fwd[name] + grad[name]
        by = f"{name}_by_path"
        launches[by] = {p: fwd[by][p] + grad[by][p] for p in fwd[by]}
    return {**launches, "shapes": {"flash_attention": attn,
                                   "ssd_intra": cell}, "seconds": seconds}


def encdec_phase(torch, np, emit, smi_line, device="cuda") -> dict:
    """Phase 15: whisper-small as published (12 + 12 layers, bf16, the
    flash kernel, seed 0) over ENCDEC_BATCH x (1,500 seeded frame
    embeddings at the token embeddings' scale, the frontend being a stub in
    both packages + ENCDEC_TEXT tokens).  ``forward`` with the flash
    kernel's launches zeroed just before and read just after (the encoder's
    12 non-causal over 1,500 keys and the decoder's 12 causal, all on
    wgmma; the cross-attention is the plain blockwise path, as in the JAX
    package), the logits against the plain attention's (``lm_bf16``),
    ``encode`` and ``forward`` ms; ``prefill_cross`` then ENCDEC_DECODE
    teacher-forced ``decode_step``s against the forward (``lm_bf16``), ms
    and aten calls a step; one ``loss_fn`` backward against the plain
    attention's (GRAD_REL a leaf); the kernel alone at the encoder's shape.
    No engine: the JAX package's engine never calls ``prefill_cross``
    (ROADMAP Queue 3 item 8).  Returns the flash launches on the path."""
    import dataclasses
    import importlib

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as trainer
    from repro_torch.models import counting, get_model, whisper

    fmod = importlib.import_module("repro_torch.kernels.flash_attention")
    flash = fmod.flash_attention
    t_phase = time.perf_counter()
    emit({"phase": "encdec", "nvidia_smi": smi_line})
    cfg = dataclasses.replace(get_config(ENCDEC_ARCH),
                              use_pallas_attention=True)
    plain_cfg = dataclasses.replace(cfg, use_pallas_attention=False)
    t0 = time.perf_counter()
    params = whisper.init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    vocab = cfg.vocab_size
    rng = np.random.default_rng(42)
    frames = torch.from_numpy(rng.normal(
        size=(ENCDEC_BATCH, cfg.encoder_seq, cfg.d_model)) * 0.02).to(
            device, torch.bfloat16)
    toks = torch.from_numpy(rng.integers(
        0, vocab, (ENCDEC_BATCH, ENCDEC_TEXT))).to(device)
    batch = {"frames": frames, "tokens": toks}
    # each launch's (causal, queries, keys), recorded on the way in
    calls, real_flash = [], ops._flash

    def recording(q, k, v, **kw):
        calls.append((kw["causal"], q.shape[1], k.shape[1]))
        return real_flash(q, k, v, **kw)

    def by_kind():
        out = {}
        for causal, sq, sk in calls:
            key = f"{'causal' if causal else 'non_causal'}_{sq}x{sk}"
            out[key] = out.get(key, 0) + 1
        return out

    ops._flash = recording
    try:
        zero_flash(fmod)                      # zero just before the path
        logits = whisper.forward(cfg, params, batch)
        torch.cuda.synchronize()
        fwd = {"flash_attention": flash.launches,   # read just after
               "flash_attention_by_path": dict(flash.launches_by_path),
               "by_kind": by_kind()}
    finally:
        ops._flash = real_flash
    n = cfg.encoder_layers + cfg.num_layers
    want_kinds = {f"non_causal_{cfg.encoder_seq}x{cfg.encoder_seq}":
                  cfg.encoder_layers,
                  f"causal_{ENCDEC_TEXT}x{ENCDEC_TEXT}": cfg.num_layers}
    line = {"part": "whisper_forward", "arch": ENCDEC_ARCH,
            "layers": [cfg.encoder_layers, cfg.num_layers],
            "reduced": "none: published depth and width",
            "batch": ENCDEC_BATCH, "frames": cfg.encoder_seq,
            "text": ENCDEC_TEXT, "launches": fwd, "nvidia_smi": smi_line}
    if fwd["flash_attention"] != n \
            or fwd["flash_attention_by_path"]["wgmma"] != n \
            or fwd["by_kind"] != want_kinds:
        emit({"phase": "encdec_failed", **line})
        raise SystemExit(f"encdec: the forward launched {fwd}, not {n} "
                         f"flash_attention on wgmma ({want_kinds})")
    plain = whisper.forward(plain_cfg, params, batch)
    torch.cuda.synchronize()
    ok, diff = agree(torch, logits[..., :vocab], plain[..., :vocab],
                     "lm_bf16")
    share = scale_share(torch, logits[..., :vocab], plain[..., :vocab],
                        "lm_bf16")
    want = logits[:, :ENCDEC_DECODE, :vocab].clone()
    finite = bool(torch.isfinite(logits).all())
    shape = tuple(logits.shape)
    del logits, plain
    if not ok or not finite \
            or shape != (ENCDEC_BATCH, ENCDEC_TEXT, cfg.vocab_padded):
        emit({"phase": "encdec_failed", **line, "limit_share": share})
        raise SystemExit(f"encdec: logits {shape} with the kernel disagree "
                         f"with the plain attention's "
                         f"({TOLERANCES['lm_bf16']}; max abs diff {diff}, "
                         f"{share} of the limit)")
    encode_ms = median_ms(torch, lambda: whisper.encode(cfg, params, frames),
                          reps=3)
    forward_ms = median_ms(torch, lambda: whisper.forward(cfg, params,
                                                          batch), reps=3)
    plain_ms = median_ms(torch, lambda: whisper.forward(plain_cfg, params,
                                                        batch), reps=3)
    emit({"phase": "encdec", **line, "max_abs_diff_vs_plain": diff,
          "limit_share": share, "tolerance": TOLERANCES["lm_bf16"],
          "encode_ms": encode_ms, "forward_ms": forward_ms,
          "plain_forward_ms": plain_ms,
          "encode_frames_per_s": ENCDEC_BATCH * cfg.encoder_seq / encode_ms
          * 1e3, "params": counting.param_count(cfg), "init_s": init_s})

    # prefill_cross, then teacher-forced decode against the forward
    zero_flash(fmod)
    cache = whisper.prefill_cross(cfg, params, whisper.init_cache(
        cfg, ENCDEC_BATCH, ENCDEC_DECODE, device=device), frames)
    torch.cuda.synchronize()
    cross = {"flash_attention": flash.launches,
             "flash_attention_by_path": dict(flash.launches_by_path)}
    if cross["flash_attention"] != cfg.encoder_layers:
        raise SystemExit(f"encdec: prefill_cross launched {cross}")
    cross_ms = median_ms(torch, lambda: whisper.prefill_cross(
        cfg, params, dict(cache), frames), reps=3)
    steps, host_s = [], 0.0
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    for pos in range(ENCDEC_DECODE):
        t0 = time.perf_counter()
        lg, cache = whisper.decode_step(cfg, params, cache, toks[:, pos],
                                        pos)
        host_s += time.perf_counter() - t0
        steps.append(lg[:, :vocab])
    ev1.record()
    torch.cuda.synchronize()
    got = torch.stack(steps, 1)
    ok, ddiff = agree(torch, got, want, "lm_bf16")
    dshare = scale_share(torch, got, want, "lm_bf16")
    del got, want, steps
    if not ok:
        raise SystemExit(f"encdec: decode disagrees with the forward "
                         f"({TOLERANCES['lm_bf16']}; max abs diff {ddiff}, "
                         f"{dshare} of the limit)")
    c0 = whisper.prefill_cross(cfg, params, whisper.init_cache(
        cfg, ENCDEC_BATCH, ENCDEC_DECODE, device=device), frames)
    decode_aten = aten_calls(torch, lambda: whisper.decode_step(
        cfg, params, c0, toks[:, 0], 0))
    del c0, cache
    emit({"phase": "encdec", "part": "whisper_decode", "steps":
          ENCDEC_DECODE, "batch": ENCDEC_BATCH,
          "prefill_cross_launches": cross, "prefill_cross_ms": cross_ms,
          "max_abs_diff_vs_forward": ddiff, "limit_share": dshare,
          "tolerance": TOLERANCES["lm_bf16"],
          "decode_ms_per_step": ev0.elapsed_time(ev1) / ENCDEC_DECODE,
          "decode_host_ms_per_step": host_s / ENCDEC_DECODE * 1e3,
          "aten_calls_per_step": decode_aten, "nvidia_smi": smi_line})

    # one loss_fn backward through the kernel against the plain attention
    api = get_model(cfg)
    gbatch = dict(batch, labels=toks)
    zero_flash(fmod)
    loss_k, g_k = trainer.make_grad_fn(cfg, api)(params, gbatch)
    torch.cuda.synchronize()
    grad = {"flash_attention": flash.launches,
            "flash_attention_by_path": dict(flash.launches_by_path)}
    loss_p, g_p = trainer.make_grad_fn(plain_cfg, api)(params, gbatch)
    rel = grad_rel(torch, g_k, g_p)
    worst = max(rel, key=rel.get)
    per = 2 if cfg.remat == "full" else 1     # forward and remat recompute
    emit({"phase": "encdec", "part": "whisper_gradient",
          "remat": cfg.remat, "loss_kernel": float(loss_k),
          "loss_plain": float(loss_p), "launches": grad,
          "grad_rel_max": rel[worst], "grad_rel_worst_leaf": worst,
          "grad_rel_attention": {k: v for k, v in rel.items()
                                 if ".attn." in k},
          "limit": GRAD_REL, "nvidia_smi": smi_line})
    if rel[worst] > GRAD_REL \
            or grad["flash_attention_by_path"]["wgmma"] != per * n:
        raise SystemExit(f"encdec: the gradient through the flash kernel "
                         f"is {rel[worst]} of the plain attention's at "
                         f"{worst} (limit {GRAD_REL}; launches {grad})")
    del params, g_k, g_p, batch, gbatch, frames, toks
    torch.cuda.empty_cache()

    # the kernel alone at the encoder's shape
    attn = flash_alone(torch, np, fmod, np.random.default_rng(12),
                       ENCDEC_BATCH * cfg.num_heads, cfg.encoder_seq,
                       cfg.encoder_seq, cfg.hd, False, "encdec")
    if attn["path"] != "wgmma":
        raise SystemExit(f"encdec: the encoder's attention takes the "
                         f"{attn['path']} kernel")
    emit({"phase": "encdec", "part": "kernel_alone",
          "kernel": "flash_attention", **attn, "nvidia_smi": smi_line})
    seconds = time.perf_counter() - t_phase
    emit({"phase": "encdec", "seconds": seconds, "all_agree": True,
          "nvidia_smi": smi_line})
    return {"flash_attention": fwd["flash_attention"]
            + cross["flash_attention"] + grad["flash_attention"],
            "flash_attention_by_path": {
                p: fwd["flash_attention_by_path"][p]
                + cross["flash_attention_by_path"][p]
                + grad["flash_attention_by_path"][p]
                for p in fwd["flash_attention_by_path"]},
            "shapes": {"flash_attention": attn}, "seconds": seconds}


#: Phase 16 (``lm_mesh``): qwen3-0.6b at full width (remat "full", the
#: flash kernel), its depth cut to LM_TRAIN_RESUME_LAYERS of 28 layers (the
#: two runs agree byte for byte at any depth), trained LM_MESH_STEPS steps at
#: LM_TRAIN_BATCH x LM_TRAIN_SEQ, a checkpoint at the end, once unmeshed and
#: once on the LM_MESH_SHAPE (data, model) mesh; the examples run with these
#: flags.
LM_MESH_STEPS, LM_MESH_SHAPE = 2, (1, 1)
#: Bytes the card may hold beyond the placed state when the first step
#: starts (the batch, the schedule's scalars, the allocator's rounding).
LM_MESH_SLACK = 64 << 20
EXAMPLES = (("quickstart_torch.py", (), "done."),
            ("serve_preemptible_torch.py", (),
             "identical to an unpreempted run: True"),
            ("train_llm_torch.py", ("--steps", "20"), "trained 20 steps"))


def run_examples(emit, build: Path) -> None:
    """The three LM examples (EXAMPLES) on the card, each in its own
    process, side by side; each must exit 0 and print its line."""
    runs = []
    for name, args, expect in EXAMPLES:
        log = build / f"lm_mesh_{Path(name).stem}.log"
        with open(log, "w") as f:
            runs.append((name, args, expect, log, time.perf_counter(),
                         subprocess.Popen([sys.executable,
                                           str(ROOT / "examples" / name),
                                           *args], stdout=f,
                                          stderr=subprocess.STDOUT,
                                          text=True)))
    try:
        ended = {}
        deadline = time.perf_counter() + 600
        while len(ended) < len(runs):
            if time.perf_counter() > deadline:
                raise SystemExit("lm_mesh: the examples ran past 600 s")
            for i, run in enumerate(runs):
                if i not in ended and run[-1].poll() is not None:
                    ended[i] = time.perf_counter() - run[4]
            time.sleep(0.2)
        for i, (name, args, expect, log, _t0, proc) in enumerate(runs):
            out = log.read_text()
            if proc.returncode != 0 or expect not in out:
                raise SystemExit(f"lm_mesh: examples/{name} failed (no "
                                 f"{expect!r}): {out[-3000:]}")
            emit({"phase": "lm_mesh", "part": "example", "example": name,
                  "args": list(args), "seconds": ended[i],
                  "side_by_side": len(runs),
                  "last_lines": out.strip().splitlines()[-3:]})
    finally:
        for *_, proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def lm_mesh_phase(torch, np, emit, smi_line, device="cuda") -> dict:
    """Phase 16: the sharded LM launch path on the card.  qwen3-0.6b at
    full width and LM_TRAIN_RESUME_LAYERS of 28 layers:
    ``launch.train.train`` for LM_MESH_STEPS steps, once with
    ``mesh=None`` and once with ``mesh=make_host_mesh(LM_MESH_SHAPE)``;
    the flash launches zeroed just before each run and read just after
    (2 a layer and step, all on wgmma: forward and remat recompute).  Each
    run's losses, step ms, peak bytes a step, and the card's allocated
    bytes when its first step starts beside ``shardings.sharded_bytes`` of
    the placed parameters and moments.  The two runs' losses must be
    equal and their checkpoint files (every parameter and AdamW moment,
    raw bits) equal byte for byte.  Then one dry-run record
    (``launch.dryrun.run_cell``: qwen3-0.6b train_4k on the 16 x 16
    mesh), and the three LM examples on the card, each in its own
    process, side by side.  Returns the flash launches of the two
    runs."""
    import dataclasses
    import filecmp
    import importlib
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, shardings
    from repro_torch.launch import train as trainer
    from repro_torch.launch.mesh import make_host_mesh

    fmod = importlib.import_module("repro_torch.kernels.flash_attention")
    flash = fmod.flash_attention
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(LM_ARCH), use_pallas_attention=True,
                              num_layers=LM_TRAIN_RESUME_LAYERS)
    if cfg.remat != "full":
        raise SystemExit(f"lm_mesh: {LM_ARCH}'s remat is {cfg.remat!r}")
    emit({"phase": "lm_mesh", "nvidia_smi": smi_line, "arch": LM_ARCH,
          "layers": cfg.num_layers, "reduced": f"{cfg.num_layers} of "
          f"{get_config(LM_ARCH).num_layers} layers; full width",
          "remat": cfg.remat, "mesh_shape": list(LM_MESH_SHAPE)})
    real = {"make_train_step": trainer.make_train_step,
            "make_sharded_train_step": trainer.make_sharded_train_step}
    steps, placed = [], {}

    def timed(make):
        def maker(*a, **kw):
            step = make(*a, **kw)

            def run(params, opt_state, batch):
                torch.cuda.synchronize()
                if not steps:                     # the placed state
                    placed["allocated"] = torch.cuda.memory_allocated() \
                        - placed["base"]
                    placed["exact"] = state_bytes(params, opt_state,
                                                  placed["mesh"])
                torch.cuda.reset_peak_memory_stats()
                f0 = flash.launches
                w0 = flash.launches_by_path["wgmma"]
                t0 = time.perf_counter()
                out = step(params, opt_state, batch)
                torch.cuda.synchronize()
                steps.append({
                    "loss": float(out[2]),
                    "step_ms": (time.perf_counter() - t0) * 1e3,
                    "flash_attention_launches": flash.launches - f0,
                    "wgmma_launches": flash.launches_by_path["wgmma"] - w0,
                    "peak_bytes": torch.cuda.max_memory_allocated()
                    - placed["base"]})
                return out
            return run
        return maker

    def state_bytes(params, opt_state, mesh) -> int:
        if mesh is None:
            return sum(x.numel() * x.element_size() for x in
                       shardings.tree_leaves([params, opt_state]))
        whole_p = shardings.gather_tree(params)
        whole_o = shardings.gather_tree(opt_state)
        return shardings.sharded_bytes(
            whole_p, shardings.tree_specs(whole_p, mesh), mesh) + \
            shardings.sharded_bytes(
                whole_o, shardings.tree_specs(whole_o, mesh, zero1=True),
                mesh)

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    runs, launches, by_path = {}, 0, {p: 0 for p in flash.launches_by_path}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tmp = Path(tmp)
        for label, mesh_shape in (("unmeshed", None),
                                  ("mesh", LM_MESH_SHAPE)):
            mesh = None if mesh_shape is None else make_host_mesh(
                mesh_shape, device=device)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            steps.clear()
            placed.clear()
            placed["base"] = torch.cuda.memory_allocated()
            placed["mesh"] = mesh
            for name, make in real.items():
                setattr(trainer, name, timed(make))
            try:
                before = dict(flash.launches_by_path)
                flash.launches = 0            # zero just before the path
                res = trainer.train(
                    cfg, steps=LM_MESH_STEPS, batch=LM_TRAIN_BATCH,
                    seq=LM_TRAIN_SEQ, ckpt_dir=str(tmp / label),
                    ckpt_interval=LM_MESH_STEPS, log_every=0, mesh=mesh,
                    device=device)
                torch.cuda.synchronize()
                n = flash.launches            # read just after
            finally:
                for name, make in real.items():
                    setattr(trainer, name, make)
            launches += n
            for p in by_path:
                by_path[p] += flash.launches_by_path[p] - before[p]
            exact = placed["exact"]
            per_step = 2 * cfg.num_layers
            if any(s["flash_attention_launches"] != per_step
                   or s["wgmma_launches"] != per_step for s in steps):
                raise SystemExit(f"lm_mesh: {label}: flash launches a step "
                                 f"{steps}, not {per_step} on wgmma")
            if not all(np.isfinite(res.losses)):
                raise SystemExit(f"lm_mesh: {label}: losses {res.losses}")
            if not 0 <= placed["allocated"] - exact <= LM_MESH_SLACK:
                raise SystemExit(f"lm_mesh: {label}: {placed['allocated']} "
                                 f"bytes allocated at the first step against "
                                 f"{exact} of placed state")
            store = trainer.SlotStore(tmp / label / "state")
            m = store.manifest()
            runs[label] = {"res": res, "dir": store.root / m["slot"],
                           "manifest": m}
            line = {"phase": "lm_mesh", "run": label,
                    "mesh": None if mesh is None else repr(mesh),
                    "losses": res.losses, "steps": list(steps),
                    "flash_attention_launches": n,
                    "allocated_bytes_at_first_step": placed["allocated"],
                    "sharded_bytes": exact,
                    "checkpoint_bytes": sum((store.root / m["slot"] / f)
                                            .stat().st_size
                                            for f in m["leaves"]),
                    "wall_s": res.wall_s, "nvidia_smi": smi_line}
            emit(line)
        a, b = runs["unmeshed"], runs["mesh"]
        same_files = a["manifest"]["leaves"] == b["manifest"]["leaves"] \
            and a["manifest"]["dtypes"] == b["manifest"]["dtypes"] \
            and a["manifest"]["meta"] == b["manifest"]["meta"] and all(
                filecmp.cmp(a["dir"] / f, b["dir"] / f, shallow=False)
                for f in a["manifest"]["leaves"])
        n_files = len(a["manifest"]["leaves"])
    if a["res"].losses != b["res"].losses or not same_files:
        raise SystemExit(f"lm_mesh: the meshed run differs from the "
                         f"unmeshed one (losses {b['res'].losses} against "
                         f"{a['res'].losses}; files equal: {same_files})")
    emit({"phase": "lm_mesh", "part": "bitwise", "losses_equal": True,
          "checkpoint_files_equal": True, "files": n_files})
    torch.cuda.empty_cache()

    # one dry-run record on the production mesh (traced on meta tensors)
    rec = dryrun.run_cell(LM_ARCH, "train_4k", False)
    if rec["status"] != "ok" or rec["flops_global"] <= 0 \
            or not isinstance(rec["memory"]["fits_hbm"], bool):
        raise SystemExit(f"lm_mesh: dry run {rec}")
    emit({"phase": "lm_mesh", "part": "dryrun", **rec})

    run_examples(emit, build)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "lm_mesh", "seconds": seconds, "all_agree": True,
          "nvidia_smi": smi_line})
    return {"flash_attention": launches, "flash_attention_by_path": by_path,
            "seconds": seconds}


#: Phase 5b: the PlanSet design sweep -- MNIST's {tile-32, sonic, tails} x
#: {100uF, 1mF} candidates, this many devices a candidate (the JAX package's
#: design_space grid with tile-32 for tile-8; lower it if the time limit
#: forces it).
DESIGN_DEVICES = 4096
#: Phase 5c: the streamed statistics -- lanes a chunk, and the two fleet
#: sizes whose peak device memory must agree within MEMORY_FLAT.
STREAM_CHUNK = 65536
STREAM_LANES = (262144, 1048576)
MEMORY_FLAT = 0.10
#: Phase 5c's capacitor sweep: capacitors (cycles a charge) x devices.
CAP_SWEEP = (1.0e5, 3.0e5, 1.0e6, 3.0e6, 1.0e7)
CAP_DEVICES = 4096


def stats_equal(np, a, b) -> list:
    """The statistics (of two ``FleetStats``) that differ in any bit."""
    bad = [f for f in ("count", "completed", "class_sums")
           if not np.array_equal(getattr(a, f), getattr(b, f))]
    for f in ("sums", "sumsqs", "mins", "maxs", "hists"):
        bad += [(f, ch) for ch in getattr(a, f)
                if not np.array_equal(getattr(a, f)[ch], getattr(b, f)[ch])]
    return bad


def host_outputs(out: dict) -> dict:
    """A replay's output tensors as numpy arrays."""
    return {k: v.cpu().numpy() for k, v in out.items()}


def zero_counts(wrapper) -> None:
    wrapper.launches = 0
    for d in wrapper.launches_by_design:
        wrapper.launches_by_design[d] = 0
    for m in wrapper.launches_by_mode:
        wrapper.launches_by_mode[m] = 0


def design_sweep(torch, np, emit, fleetsim, cr, rec, wrapper, net, x,
                 plan_tails, plan_sonic) -> dict:
    """Phase 5b: a PlanSet of MNIST's candidates in one launch of the lane
    kernel in plan mode, against each candidate's own sweep, the direct
    design and its statistics; returns the numbers the kernels line
    reports."""
    from repro_torch.core.energy import make_power_system
    from repro_torch.core.fleetstats import stats_from_outputs

    def restamp(plan, power):
        ps = make_power_system(power)
        return fleetsim.dataclasses.replace(
            plan, power=ps.name, recharge_s=ps.recharge_s,
            capacity=ps.cycles_per_charge)

    t0 = time.perf_counter()
    plan_t32 = fleetsim.build_plan(net, x, "tile-32", "1mF")
    tails_100 = fleetsim.build_plan(
        net, x, "tails", "100uF",
        ref=(plan_tails.ref_output, plan_tails.max_atomic))
    plans = [restamp(plan_t32, "100uF"), plan_t32,
             restamp(plan_sonic, "100uF"), plan_sonic, tails_100, plan_tails]
    labels = [f"mnist/{p.strategy}/{p.power}" for p in plans]
    ps = fleetsim.PlanSet.from_plans(plans, labels=labels)
    build_s = time.perf_counter() - t0
    kw = dict(n_devices=DESIGN_DEVICES, seed=7, charge_cv=0.25,
              charge_reboots=64, trace_reboots=16, device="cuda")
    lanes = len(ps) * DESIGN_DEVICES

    rec.calls = []
    zero_counts(wrapper)                  # just before the design sweep
    t0 = time.perf_counter()
    res = fleetsim.fleet_sweep(plan=ps, **kw)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = wrapper.launches            # read just after
    by_mode = dict(wrapper.launches_by_mode)
    by_design = dict(wrapper.launches_by_design)
    if by_mode != {"shared": 0, "lane": 0, "plan": launches} \
            or launches < 1 or by_design["direct"] != 0:
        raise SystemExit(f"design_sweep: launched {by_design} in modes "
                         f"{by_mode}, not the hoisted design in plan mode")
    call = rec.calls[0]
    a, kw_call = call["args"], call["kw"]
    ev0, ev1 = call["events"]
    sweep_ms = ev0.elapsed_time(ev1)

    # every candidate against its own fleet sweep on the card
    solo_ms, rows = [], []
    for p, plan in enumerate(plans):
        rec.calls = []
        solo = fleetsim.fleet_sweep(plan=plan, **kw)
        torch.cuda.synchronize()
        e0, e1 = rec.calls[0]["events"]
        solo_ms.append(e0.elapsed_time(e1))
        for ch in ("completed", "live_s", "dead_s", "reboots", "energy_j",
                   "wasted_cycles", "belief_cycles"):
            if not np.array_equal(getattr(res, ch)[p], getattr(solo, ch)):
                raise SystemExit(f"design_sweep: {labels[p]} {ch} != its "
                                 f"own fleet_sweep")
        rows.append({"label": labels[p], "rows": len(plan),
                     "completion_rate": float(res.completed[p].mean()),
                     "solo_ms": solo_ms[-1]})

    # the plan-mode launch again on the direct design, bitwise
    direct = wrapper(*a, **kw_call, design="direct")
    torch.cuda.synchronize()
    ok, _err, bad = compare(torch, call["out"], direct)
    if not ok:
        raise SystemExit(f"design_sweep: the direct design in plan mode != "
                         f"the hoisted one on {bad}")
    del direct
    ms = median_ms(torch, lambda: wrapper(*a, **kw_call), reps=3)

    # reduce="stats" of the same sweep against its own materialized lanes
    st = fleetsim.fleet_sweep(plan=ps, reduce="stats", **kw)
    ref = stats_from_outputs(host_outputs(call["out"]), st.edges,
                             group_id=np.repeat(np.arange(len(ps)),
                                                DESIGN_DEVICES),
                             n_groups=len(ps))
    bad = stats_equal(np, st, ref)
    if bad:
        raise SystemExit(f"design_sweep: reduce='stats' != "
                         f"stats_from_outputs on {bad}")
    table = a[0].packed
    line = {"phase": "design_sweep", "candidates": rows,
            "devices_per_candidate": DESIGN_DEVICES, "lanes": lanes,
            "table_shape": list(table.shape),
            "table_bytes": table.numel() * table.element_size(),
            "plan_build_s": build_s, "wall_s": wall_s,
            "launches": launches, "launches_by_mode": by_mode,
            "kernel_ms": ms, "first_launch_ms": sweep_ms,
            "lanes_per_s": lanes / (ms / 1e3),
            "solo_ms_sum": sum(solo_ms),
            "bitwise_equal_solo": True, "bitwise_equal_direct_design": True,
            "stats_bitwise_equal_stats_from_outputs": True}
    emit(line)
    return line


#: The overlapped pipeline's waits: spans that time no host work.
PIPELINE_WAITS = ("entry/queue_wait", "entry/thread_join",
                  "pipeline/slot_wait", "pipeline/setup_wait")


def host_report(snap: dict) -> dict:
    """Host seconds by thread and function from a snapshot of the
    program's spans (``repro_torch.runtime.spans``): for the caller and
    the pipeline's producer, the wall and CPU seconds of the host work in
    spans (their self times summed, the pipeline's waits left out), and
    each span's whole wall and CPU seconds and calls by its name.  A
    span's wall time well above its CPU time was spent waiting for a core,
    for the interpreter lock or for the card."""
    out = {}
    for role in ("caller", "producer"):
        work = [(k, v[role]) for k, v in snap.items() if role in v]
        out[role] = {
            "s": sum(h["self_s"] for k, h in work
                     if k not in PIPELINE_WAITS),
            "cpu_s": sum(h["self_cpu_s"] for k, h in work
                         if k not in PIPELINE_WAITS),
            "by_function": {snap[k]["name"]: {"s": h["wall_s"],
                                              "cpu_s": h["cpu_s"],
                                              "calls": h["calls"]}
                            for k, h in work}}
    return out


def span_report(snap: dict, calls: int, call_s: float) -> dict:
    """Readings a call of a snapshot of the program's spans taken over
    ``calls`` calls of ``call_s`` seconds in all (host clock): each
    layer's own host ms (self times, both threads, the pipeline's waits
    left out), the pipeline's waits (wall ms), the card's ms in each
    ``host_only`` span (its idle waiting on that step) and their share of
    the calls' time (``host_gap_share``, %; ``None`` where no card timed
    them)."""
    per = 1e3 / calls
    layers, waits, gaps = {}, {}, {}
    for k, v in sorted(snap.items()):
        for role in ("caller", "producer"):
            if role not in v:
                continue
            if k in PIPELINE_WAITS:
                waits[k] = waits.get(k, 0.0) + v[role]["wall_s"] * per
            else:
                layers[v["layer"]] = layers.get(v["layer"], 0.0) \
                    + v[role]["self_s"] * per
        if v["host_only"] and "device_s" in v:
            gaps[k] = v["device_s"] * per
    out = {"self_ms_per_call": layers, "wait_ms_per_call": waits,
           "host_gap_ms_per_call": gaps,
           "host_gap_share": 100.0 * sum(gaps.values()) / (call_s * per)
           if gaps else None}
    return out


def host_threads(torch, np) -> dict:
    """The host's cores and the thread pools that share them."""
    info = {"os_cpu_count": os.cpu_count(),
            "affinity_cores": len(os.sched_getaffinity(0)),
            "torch_threads": torch.get_num_threads(),
            "torch_interop_threads": torch.get_num_interop_threads(),
            "env": {k: os.environ.get(k) for k in (
                "OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "CUDA_DEVICE_MAX_CONNECTIONS") if os.environ.get(k)},
            "switch_interval_s": sys.getswitchinterval()}
    try:
        cfg = np.show_config(mode="dicts")
        info["numpy_blas"] = cfg["Build Dependencies"]["blas"].get("name")
    except (TypeError, KeyError):
        info["numpy_blas"] = "not reported"
    try:
        from threadpoolctl import threadpool_info
        info["blas_threads"] = [(p.get("internal_api"), p.get("num_threads"))
                                for p in threadpool_info()]
    except ImportError:
        info["blas_threads"] = "threadpoolctl is not installed"
    return info


#: The ``overlap`` phase: the JAX package's own overlap protocol
#: (``benchmarks/fleet.py`` ``_overlap_comparison`` and its smoke gate) run
#: through the port -- its device network, sonic/1mF, seed 7,
#: ``reduce="stats"``, this many recharges a lane, lanes in chunks of
#: ``SCALING_LANE_CHUNK``; one warm-up, then the minimum of 2 runs a mode.
OVERLAP_LANES = 100_000
OVERLAP_CHUNK = 8192
OVERLAP_TRACE_REBOOTS = 256
#: The gate of that protocol: prefetch=1 at least this many times as fast
#: as prefetch=0, and its peak lane bytes at most twice the single-chunk
#: footprint.
OVERLAP_FLOOR = 0.95


def device_net(np, classes):
    """The JAX benchmark's mid-sized device network (``benchmarks/fleet.py``
    ``_device_net``), rebuilt from its seed: a 4-filter 5x5 conv, a 2x2
    pool and a 256 -> 10 dense layer over a 20 x 20 input."""
    Conv2D, DenseFC, MaxPool2D, SimNet = classes[:4]
    rng = np.random.default_rng(0)
    net = SimNet([
        Conv2D((rng.normal(size=(4, 1, 5, 5)) * 0.3).astype(np.float32),
               rng.normal(size=4).astype(np.float32)),
        MaxPool2D(2),
        DenseFC((rng.normal(size=(10, 256)) * 0.1).astype(np.float32),
                rng.normal(size=10).astype(np.float32), relu=False),
    ], input_shape=(1, 20, 20), name="fleetdev")
    x = rng.normal(size=(1, 20, 20)).astype(np.float32)
    return net, x


def timed_sweep(torch, fleetsim, **kw) -> tuple:
    """One streamed ``fleet_sweep`` on the card: its statistics, and its
    wall seconds, peak device memory over the baseline and host seconds
    by thread and function (the program's spans, which the caller turns
    on)."""
    from repro_torch.runtime import spans

    spans.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    st = fleetsim.fleet_sweep(**kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return st, {"wall_s": wall, "sweep_wall_s": st.wall_s,
                "peak_over_base_bytes": torch.cuda.max_memory_allocated()
                - base, "peak_lane_bytes": st.peak_lane_bytes,
                "host": host_report(spans.snapshot())}


def overlap(torch, np, emit, fleetsim, classes) -> dict:
    """Phase 5d: the overlapped chunk pipeline (prefetch=1) against the
    synchronous loop (prefetch=0) under the JAX package's own protocol and
    gate; exits non-zero below ``OVERLAP_FLOOR`` or above twice the
    single-chunk footprint."""
    from repro_torch.core.fleetstats import default_stat_edges, \
        partial_nbytes
    from repro_torch.runtime import failures, spans

    net, x = device_net(np, classes)
    kw = dict(net=net, x=x, strategy="sonic", power="1mF",
              n_devices=OVERLAP_LANES, seed=7, reduce="stats",
              lane_chunk=OVERLAP_CHUNK, trace_reboots=OVERLAP_TRACE_REBOOTS,
              device="cuda")
    runs = {0: [], 1: []}
    spans.enable(events=False)
    try:
        timed_sweep(torch, fleetsim, prefetch=0, **kw)          # warm-up
        for prefetch in (0, 0, 1, 1):
            runs[prefetch].append(timed_sweep(torch, fleetsim,
                                              prefetch=prefetch, **kw))
    finally:
        spans.disable()
    seq = min(runs[0], key=lambda r: r[0].wall_s)
    ovl = min(runs[1], key=lambda r: r[0].wall_s)
    bad = stats_equal(np, seq[0], ovl[0])
    if bad:
        raise SystemExit(f"overlap: prefetch 0 != 1 on {bad}")
    # the hideable host time: the chunk samplers alone
    plan = fleetsim.build_plan(net, x, "sonic", "1mF")
    t0 = time.perf_counter()
    for lo in range(0, OVERLAP_LANES, OVERLAP_CHUNK):
        m = min(OVERLAP_CHUNK, OVERLAP_LANES - lo)
        failures.initial_charge_fraction_stream(m, seed=7, lane_lo=lo)
        jm = failures.harvest_jitter_stream(m, seed=7, cv=0.25, lane_lo=lo)
        tr = failures.reboot_recharge_times_stream(
            m, OVERLAP_TRACE_REBOOTS, plan.recharge_s, seed=7, lane_lo=lo)
        failures.recharge_trace_cumulative(tr * jm[:, None])
    sampler_s = time.perf_counter() - t0
    edges = default_stat_edges(plan.total_cycles, plan.capacity,
                               plan.recharge_s, 64)
    footprint = int(seq[0].peak_lane_bytes) + partial_nbytes(edges, 1)
    speedup = seq[0].wall_s / ovl[0].wall_s
    line = {"phase": "overlap", "protocol": "benchmarks/fleet.py "
            "_overlap_comparison: device net, sonic/1mF, seed 7, one "
            "warm-up, min of 2 a mode", "plan_rows": len(plan),
            "lanes": OVERLAP_LANES, "lane_chunk": OVERLAP_CHUNK,
            "trace_reboots": OVERLAP_TRACE_REBOOTS,
            "seq_wall_s": seq[0].wall_s, "overlapped_wall_s": ovl[0].wall_s,
            "seq_walls_s": [r[0].wall_s for r in runs[0]],
            "overlapped_walls_s": [r[0].wall_s for r in runs[1]],
            "seq_lanes_per_sec": OVERLAP_LANES / seq[0].wall_s,
            "overlapped_lanes_per_sec": OVERLAP_LANES / ovl[0].wall_s,
            "overlap_speedup": speedup,
            "sampler_fraction": sampler_s / seq[0].wall_s,
            "seq_peak_lane_bytes": int(seq[0].peak_lane_bytes),
            "overlapped_peak_lane_bytes": int(ovl[0].peak_lane_bytes),
            "single_chunk_footprint_bytes": footprint,
            "seq_peak_device_over_base_bytes":
                seq[1]["peak_over_base_bytes"],
            "overlapped_peak_device_over_base_bytes":
                ovl[1]["peak_over_base_bytes"],
            "seq_host": seq[1]["host"], "overlapped_host": ovl[1]["host"],
            "stats_bitwise_equal": True,
            "default_prefetch": fleetsim.DEFAULT_PREFETCH,
            "host_threads": host_threads(torch, np)}
    emit(line)
    if speedup < OVERLAP_FLOOR:
        raise SystemExit(f"overlap: the overlapped pipeline ran "
                         f"{speedup:.3f}x as fast as the synchronous loop "
                         f"(floor {OVERLAP_FLOOR})")
    if ovl[0].peak_lane_bytes > 2 * footprint:
        raise SystemExit(f"overlap: overlapped peak {ovl[0].peak_lane_bytes}"
                         f" B exceeds twice the single-chunk footprint "
                         f"{footprint} B")
    return line


def streamed_stats(torch, np, emit, fleetsim, cr, rec, wrapper, net, x,
                   plan_tails, lat) -> dict:
    """Phase 5c: the memory-flat streamed sweep (reduce="stats",
    lane_chunk, prefetch) of MNIST under tails/1mF adaptive, the fold
    kernel against its plain version on one chunk, and a capacitor sweep's
    statistics; returns the fold's entry of the kernels line."""
    from repro_torch.core.fleetstats import stats_from_outputs
    from repro_torch.kernels import stats_fold as sf
    from repro_torch.runtime import spans

    kw = dict(plan=plan_tails, seed=42, charge_cv=0.25, charge_reboots=64,
              trace_reboots=64, policy="adaptive", theta=0.5, batch_rows=4,
              belief_alpha=0.2, reduce="stats", lane_chunk=STREAM_CHUNK,
              device="cuda")
    cr.charge_replay = wrapper            # no recorder in the timed runs
    fold_launches = replay_launches = 0

    def run(lanes, prefetch):
        nonlocal fold_launches, replay_launches
        sf.stats_fold.launches = 0        # just before the streamed run
        zero_counts(wrapper)
        st, m = timed_sweep(torch, fleetsim, n_devices=lanes,
                            prefetch=prefetch, **kw)
        chunks = -(-lanes // STREAM_CHUNK)
        launches = (sf.stats_fold.launches, wrapper.launches)  # after
        if launches != (chunks, chunks) \
                or wrapper.launches_by_design["hoisted"] != chunks:
            raise SystemExit(f"streamed_stats: {lanes} lanes in {chunks} "
                             f"chunks launched the fold and the lane "
                             f"kernel {launches} times")
        fold_launches += launches[0]
        replay_launches += launches[1]
        if int(st.count.sum()) != lanes or not np.isfinite(
                st.sums["live_cycles"]).all():
            raise SystemExit("streamed_stats: counts or sums are off")
        return st, dict(m, lanes=lanes, prefetch=prefetch, chunks=chunks,
                        lanes_per_s=lanes / m["wall_s"],
                        completion_rate=float(st.completed.sum()
                                              / st.count.sum()),
                        fold_launches=launches[0],
                        replay_launches=launches[1])

    # one warm-up a mode, then the modes in turns, the minimum of 2 a mode
    small = STREAM_LANES[0]
    runs = {0: [], 1: []}
    spans.enable(events=False)
    try:
        run(small, 0)
        run(small, 1)
        for prefetch in (0, 1, 0, 1):
            runs[prefetch].append(run(small, prefetch))
        big = run(STREAM_LANES[1], 1)
    finally:
        spans.disable()
    seq = min(runs[0], key=lambda r: r[1]["wall_s"])
    ovl = min(runs[1], key=lambda r: r[1]["wall_s"])
    for st, row in (seq, ovl, big):
        emit({"phase": "streamed_stats", "lane_chunk": STREAM_CHUNK, **row})
    bad = stats_equal(np, seq[0], ovl[0])
    if bad:
        raise SystemExit(f"streamed_stats: prefetch 0 != 1 on {bad}")
    speedup = seq[1]["wall_s"] / ovl[1]["wall_s"]
    emit({"phase": "streamed_stats", "lanes": small,
          "protocol": "one warm-up a mode, then the modes in turns, min of "
                      "2 a mode",
          "seq_walls_s": [r[1]["wall_s"] for r in runs[0]],
          "overlapped_walls_s": [r[1]["wall_s"] for r in runs[1]],
          "overlap_speedup": speedup, "stats_bitwise_equal": True})
    if speedup < OVERLAP_FLOOR:
        raise SystemExit(f"streamed_stats: the overlapped pipeline ran "
                         f"{speedup:.3f}x as fast as the synchronous loop "
                         f"(floor {OVERLAP_FLOOR})")
    small_peak = ovl[1]["peak_over_base_bytes"]
    large_peak = big[1]["peak_over_base_bytes"]
    if abs(large_peak - small_peak) > MEMORY_FLAT * small_peak:
        raise SystemExit(f"streamed_stats: peak device memory {large_peak} "
                         f"B at {STREAM_LANES[1]} lanes vs {small_peak} B at "
                         f"{small}: not flat")

    # the fold kernel against its plain version on one chunk's outputs
    folds = []
    real_reduce = fleetsim.reduce_lane_outputs

    def keep(*args):
        folds.append(args)
        return real_reduce(*args)

    fleetsim.reduce_lane_outputs = keep
    try:
        fleetsim.fleet_sweep(n_devices=STREAM_CHUNK, prefetch=1, **kw)
    finally:
        fleetsim.reduce_lane_outputs = real_reduce
    torch.cuda.synchronize()
    out, gid, valid, edges, n_groups = folds[0]
    got = sf.stats_fold(out, gid, valid, edges, n_groups)
    torch.cuda.synchronize()
    plain = sf.stats_fold_plain({k: v.cpu() for k, v in out.items()},
                                gid.cpu(), valid.cpu(),
                                {k: e.cpu() for k, e in edges.items()},
                                n_groups)
    max_diff = 0.0
    for g_part, p_part in zip(got, plain):
        for k in g_part:
            a, b = g_part[k].cpu(), p_part[k]
            same = (a == b) | (a.isnan() & b.isnan())
            fin = a.isfinite() & b.isfinite()
            if bool(fin.any()):
                max_diff = max(max_diff, float((a - b)[fin].abs().max()))
            if not bool(same.all()):
                raise SystemExit(f"streamed_stats: fold kernel != plain on "
                                 f"{k}")
    fold_ms = median_ms(torch, lambda: sf.stats_fold(out, gid, valid, edges,
                                                     n_groups))
    plain_card_ms = median_ms(torch, lambda: sf.stats_fold_plain(
        out, gid, valid, edges, n_groups), reps=3)
    t0 = time.perf_counter()
    sf.stats_fold_plain({k: v.cpu() for k, v in out.items()}, gid.cpu(),
                        valid.cpu(), {k: e.cpu() for k, e in edges.items()},
                        n_groups)
    plain_host_ms = (time.perf_counter() - t0) * 1e3
    n = int(gid.shape[0])
    in_bytes = (sum(out[k].numel() * 8 for k in sf.LANE_KEYS)
                + out["classes"].numel() * 8 + out["stuck"].numel()
                + valid.numel() + gid.numel() * 4
                + sum(e.numel() * 8 for e in edges.values()))
    out_bytes = sum(t.numel() * 8 for part in got for t in part.values())
    # the f64 operations a lane needs: the class and channel sums, the
    # squares, total_s's division and add, tx_joules' product, and a
    # comparison each for min and max
    ops = n * (2 + out["classes"].shape[1] + 2 * 10 + 10 + 3 + 2 * 10)
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F64_OPS * 1e3
    bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes \
        else (t_bytes, "bytes")
    chain_ms = n * lat["add_cycles"] / lat["sm_clock_ghz"] * 1e-6
    fold = {"phase": "streamed_stats", "fold": "one chunk", "lanes": n,
            "bitwise_equal_plain": True, "max_abs_diff_vs_plain": max_diff,
            "fold_ms_per_chunk": fold_ms, "bytes": in_bytes + out_bytes,
            "bytes_ms": t_bytes, "f64_ops": ops, "ops_ms": t_ops,
            "chain_floor_ms": chain_ms,
            "fold_bound_ms": max(t_bytes, chain_ms),
            "fold_bound_by": "lane-order chain" if chain_ms >= t_bytes
            else "bytes",
            "chain": f"{n} lanes x {lat['add_cycles']:.3f} cycles at "
                     f"{lat['sm_clock_ghz']:.4f} GHz",
            "plain_card_ms": plain_card_ms, "plain_host_ms": plain_host_ms}
    emit(fold)

    # a capacitor sweep's groups against its own materialized lanes
    pplan = fleetsim.build_plan(net, x, "tails", "1mF", parametric=True)
    cap_kw = dict(plan=pplan, n_devices=CAP_DEVICES, seed=5,
                  charge_cv=0.25, charge_reboots=64, device="cuda")
    cr.charge_replay = rec
    rec.calls = []
    before = wrapper.launches
    cn = fleetsim.capacitor_sweep(None, None, CAP_SWEEP, **cap_kw)
    torch.cuda.synchronize()
    if wrapper.launches != before + 1 or len(rec.calls) != 1:
        raise SystemExit("capacitor_sweep: not one lane-kernel launch")
    raw = host_outputs(rec.calls[0]["out"])
    cr.charge_replay = wrapper
    fold_before = sf.stats_fold.launches
    cs = fleetsim.capacitor_sweep(None, None, CAP_SWEEP, reduce="stats",
                                  **cap_kw)
    if sf.stats_fold.launches != fold_before + 1:
        raise SystemExit("capacitor_sweep: the stats did not launch the "
                         "fold kernel")
    ref = stats_from_outputs(raw, cs.edges, group_id=np.repeat(
        np.arange(len(CAP_SWEEP)), CAP_DEVICES), n_groups=len(CAP_SWEEP))
    bad = stats_equal(np, cs, ref)
    if bad:
        raise SystemExit(f"capacitor_sweep: reduce='stats' != "
                         f"stats_from_outputs on {bad}")
    emit({"phase": "streamed_stats", "capacitor_sweep": list(CAP_SWEEP),
          "devices": CAP_DEVICES,
          "completion_rate": [float(c) for c in cn.completed.mean(1)],
          "stats_bitwise_equal_stats_from_outputs": True})
    return {
        "name": "stats_fold", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stats_fold.cu",
        "replaces": "src/repro/core/fleetstats.py:143",
        "replaces_function": "reduce_lane_outputs (an XLA function with "
                             "no Pallas kernel)",
        "launches": fold_launches, "max_abs_err": max_diff,
        "max_abs_diff_vs_plain": max_diff, "ms": fold_ms,
        "plain_ms": plain_card_ms, "plain_host_ms": plain_host_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "chain_floor_ms": chain_ms, "library_ms": None,
        "shape": f"{n} lanes, {n_groups} group, "
                 f"{sum(e.numel() - 1 for e in edges.values())} bins"}


#: Phase 5c': lanes of the closed form's runs (the benchmark's query chunk
#: and twice it) and the seed of their fleets.
CLOSED_FORM_LANES = (8192, 16384)
CLOSED_FORM_SEED = 3000000001

def aten_graph_scan(torch, fleetsim, rows, cap, rem0, trace_cum, tail_s,
                    theta, conf, radio, *, adaptive, parametric,
                    shared_rows, has_send, plan_idx=None) -> dict:
    """The closed form as the port ran it on the card before its kernel,
    ``fleetsim._scan_replay``'s arguments: ``fleetsim._scan_step`` (aten,
    some 165 launches a row) on the first row eagerly, then one CUDA graph
    of a row's launches, captured on a side stream, replayed for every
    other row.  The yardstick of phase 5c'."""
    from repro_torch.kernels.charge_replay import _packed, unpack_row

    packed, layout = _packed(rows, shared_rows)
    plan = None if plan_idx is None else plan_idx.to(torch.int64)
    st = fleetsim._scan_state0(cap, rem0)
    cursor = torch.zeros(cap.shape[0], dtype=torch.int64, device=cap.device)

    def row_step():
        new = fleetsim._scan_step(cap, trace_cum, tail_s, theta, conf, radio,
                                  adaptive, parametric, has_send, st,
                                  unpack_row(packed, layout, cursor, plan))
        for dst, src in zip(st, new):
            dst.copy_(src)
        cursor.add_(1)

    n_rows = packed.shape[-2]
    if n_rows:
        row_step()
    if n_rows > 1:
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                row_step()
            finally:
                graph.capture_end()
        main.wait_stream(side)
        for _ in range(n_rows - 1):
            graph.replay()
    return fleetsim._scan_outputs(st)


def _on_cpu(v):
    """A closed-form argument on the CPU: tensors, and row dicts of them."""
    if isinstance(v, dict):
        return {k: _on_cpu(x) for k, x in v.items()}
    return v.cpu() if hasattr(v, "cpu") else v


def closed_form_phase(torch, np, emit, fleetsim, plan) -> list[dict]:
    """Phase 5c': the closed form's kernel (``fleetsim._scan_replay`` on
    CUDA tensors) on one ``reduce="stats"`` query call of ``plan``
    (MNIST's tails/1mF: nominal charges, ``recharge_cv`` 0.25) at each of
    :data:`CLOSED_FORM_LANES` lanes: the kernel's launches and the plan's
    rows counted over the query call itself (zeroed just before, read just
    after: one launch, the plan's rows), then on that call's arguments the
    kernel's median of 5 runs between CUDA events beside the aten per-row
    graph it replaced (:func:`aten_graph_scan`, one run), every channel of
    the query's own outputs bitwise equal to the graph's, and the bound by
    operations; at the first lane count also the plain version (the CPU's
    row loop on the same arguments), timed and held bitwise."""
    from repro_torch.kernels import closed_form as cf
    from repro_torch.kernels.charge_replay import lane_block

    scan, rr = fleetsim._scan_replay, fleetsim._replay_rows
    lines = []
    for lanes in CLOSED_FORM_LANES:
        calls = []

        def capture(*a, **k):
            out = scan(*a, **k)
            calls.append((a, k, out))
            return out

        fleetsim._scan_replay = capture
        try:
            cf.closed_form.launches = rr.rows = 0   # zero just before
            fleetsim.fleet_sweep(plan=plan, n_devices=lanes,
                                 seed=CLOSED_FORM_SEED, recharge_cv=0.25,
                                 reduce="stats", device="cuda")
            torch.cuda.synchronize()
            counted = (cf.closed_form.launches, rr.rows)   # read just after
        finally:
            fleetsim._scan_replay = scan
        if counted != (1, len(plan)) or len(calls) != 1:
            raise SystemExit(f"closed_form: the query at {lanes} lanes "
                             f"counted (launches, rows) {counted} over "
                             f"{len(calls)} calls, not (1, {len(plan)}) "
                             f"over one")
        (a, k, out), = calls
        ms = median_ms(torch, lambda: scan(*a, **k))
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        ref = aten_graph_scan(torch, fleetsim, *a, **k)
        ev1.record()
        torch.cuda.synchronize()
        graph_ms_ = ev0.elapsed_time(ev1)
        ok, err, bad = compare(torch, out, ref)
        if not ok:
            raise SystemExit(f"closed_form: the kernel != the aten graph at "
                             f"{lanes} lanes on {bad} (max abs {err})")
        bound_ms = (cf.MIN_F64_OPS_PER_ROW * lanes * len(plan)
                    / PEAK_F64_OPS * 1e3)
        line = {"phase": "closed_form", "lanes": lanes, "rows": len(plan),
                "block": lane_block(lanes), "ms": ms,
                "us_per_row": ms * 1e3 / len(plan),
                "previous_ms": graph_ms_,
                "previous_us_per_row": graph_ms_ * 1e3 / len(plan),
                "speedup": graph_ms_ / ms, "bound_ms": bound_ms,
                "bound_by": "operations", "bitwise_equal_aten_graph": True,
                "launches": counted[0], "rows_counted": counted[1]}
        if not lines:
            t0 = time.perf_counter()
            plain = scan(*(_on_cpu(v) for v in a),
                         **{n: _on_cpu(v) for n, v in k.items()})
            line["plain_ms"] = (time.perf_counter() - t0) * 1e3
            ok, err, bad = compare(torch, out, {
                n: v.to(out[n].device) for n, v in plain.items()})
            if not ok:
                raise SystemExit(f"closed_form: the kernel != the CPU's row "
                                 f"loop at {lanes} lanes on {bad}")
            line.update(bitwise_equal_plain=True, max_abs_err=err)
        emit(line)
        lines.append(line)
    return lines


def closed_form_entry(lines: list, launches: dict) -> dict:
    """The kernels line's ``closed_form`` entry: times, bound and plain
    version from phase 5c''s first line (:data:`CLOSED_FORM_LANES`'s first
    count, the benchmark's query chunk), ``launches`` the kernel's
    launches counted on each main-path phase that runs it, by phase."""
    head = lines[0]
    return {"name": "closed_form", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/closed_form.cu",
            "replaces": "src/repro/core/fleetsim.py:875",
            "replaces_function": "_scan_one (a lax.scan of _scan_step, "
                                 "which XLA fuses; no Pallas kernel)",
            "launches": sum(launches.values()),
            "launches_by_phase": dict(launches),
            "max_abs_err": head["max_abs_err"],
            "max_abs_diff_vs_plain": head["max_abs_err"],
            "ms": head["ms"], "previous_ms": head["previous_ms"],
            "previous": "the aten closed form, one CUDA graph of a row's "
                        "launches replayed a row",
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            "shape": f"{head['rows']} rows x {head['lanes']} lanes",
            "by_lanes": [{k: ln[k] for k in ("lanes", "ms", "previous_ms",
                                             "bound_ms")} for ln in lines]}


#: Phase 5f: the legacy ``backend="_while"`` oracle on the card -- lanes a
#: run and a design candidate, the charge jitter and its draws.
WHILE_LANES = 64
WHILE_CHARGES = 16
WHILE_CV = 0.25
#: Phase 5g: ``mesh=`` -- lanes (not a power of two), the streamed chunk,
#: and the capacitor grid's devices (capacitors from CAP_SWEEP).
MESH_LANES = 16387
MESH_CHUNK = 4096
MESH_CAP_DEVICES = 1024
#: The result arrays of a fleet sweep and of a design sweep.
SWEEP_ARRAYS = ("completed", "live_s", "dead_s", "reboots", "energy_j",
                "wasted_cycles", "belief_cycles", "tx_bytes", "msgs_sent",
                "msgs_deferred", "tx_joules", "classes")
GRID_ARRAYS = ("completed", "live_s", "dead_s", "reboots", "energy_j",
               "wasted_cycles", "belief_cycles")


def arrays_differ(np, a, b, names) -> list:
    """The result arrays (of two sweep results) that differ in any bit."""
    return [n for n in names if not np.array_equal(
        getattr(a, n), getattr(b, n), equal_nan=True)]


def while_oracle(torch, np, emit, fleetsim, wrapper, classes) -> dict:
    """Phase 5f: the legacy oracle (``backend="_while"``: a row scan with a
    data-dependent charge loop a row, eager on the card) against the lane
    kernel (``backend="cuda"``) and the plain event stream
    (``backend="torch"``) on a small network with charge jitter: tails
    adaptive (batch_rows=2), sonic fixed, a ``with_uplink`` plan under the
    topk-hedge radio, and a 3-candidate ``PlanSet`` design sweep; every
    channel bitwise."""
    from repro_torch.core.energy import rf_recharge_seconds
    from repro_torch.runtime.radio import RadioModel, SEND_POLICIES, \
        pack_radio

    net, x = random_net(3, classes)

    def restamp(strategy, frac):
        """The plan on a capacitor of ``frac`` of its work, so that every
        lane reboots."""
        p = fleetsim.build_plan(net, x, strategy, "1mF")
        cap = max(2000.0, float(np.rint(frac * p.total_cycles)))
        return fleetsim.dataclasses.replace(
            p, capacity=cap, recharge_s=float(rf_recharge_seconds(cap)))

    radio = pack_radio(RadioModel(window_period_s=0.05, window_duty=0.3),
                       SEND_POLICIES[1])
    jitter = dict(seed=11, charge_cv=WHILE_CV, charge_reboots=WHILE_CHARGES,
                  trace_reboots=8, device="cuda")
    tails = restamp("tails", 0.15)
    runs = [
        ("tails/adaptive/batch_rows=2", dict(
            plan=tails, policy="adaptive", theta=0.5, batch_rows=2,
            belief_alpha=0.2), SWEEP_ARRAYS),
        ("sonic/fixed", dict(plan=restamp("sonic", 0.2), policy="fixed"),
         SWEEP_ARRAYS),
        ("tails/adaptive/uplink-topk-hedge", dict(
            plan=tails, policy="adaptive", theta=0.5, batch_rows=2,
            radio=radio), SWEEP_ARRAYS),
        ("planset/3-candidates", dict(
            plan=fleetsim.PlanSet.from_plans(
                [restamp("sonic", 0.08), tails, restamp("tile-8", 0.3)]),
            policy="adaptive", theta=0.5, batch_rows=2),
         GRID_ARRAYS + ("tx_bytes", "msgs_sent", "msgs_deferred")),
    ]
    lines = []
    for label, kw, names in runs:
        res, wall = {}, {}
        for backend in ("_while", "cuda", "torch"):
            steps = fleetsim._while_replay.charge_steps
            launches = wrapper.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[backend] = fleetsim.fleet_sweep(
                n_devices=WHILE_LANES, backend=backend, **jitter, **kw)
            torch.cuda.synchronize()
            wall[backend] = time.perf_counter() - t0
            if backend == "_while":
                charge_steps = fleetsim._while_replay.charge_steps - steps
                if charge_steps < 1 or wrapper.launches != launches:
                    raise SystemExit(f"while_oracle: {label} ran "
                                     f"{charge_steps} charges and launched "
                                     f"{wrapper.launches - launches} kernels")
            elif backend == "cuda" and wrapper.launches != launches + 1:
                raise SystemExit(f"while_oracle: {label} on backend='cuda' "
                                 f"did not launch the lane kernel once")
        for other in ("cuda", "torch"):
            bad = arrays_differ(np, res["_while"], res[other], names)
            if bad:
                raise SystemExit(f"while_oracle: {label}: _while != "
                                 f"{other} on {bad}")
        done = res["_while"].completed
        line = {"phase": "while_oracle", "run": label,
                "lanes": int(done.size), "charge_steps": charge_steps,
                "wall_s": wall, "completion_rate": float(done.mean()),
                "mean_reboots": float(res["_while"].reboots.mean()),
                "bitwise_equal_cuda": True, "bitwise_equal_torch": True,
                "channels": list(names)}
        emit(line)
        lines.append(line)
    return {"runs": len(lines),
            "charge_steps": sum(ln["charge_steps"] for ln in lines)}


def mesh(torch, np, emit, fleetsim, wrapper, net, x, plan_tails) -> dict:
    """Phase 5g: ``mesh=`` on the card.  ``make_fleet_mesh()`` (every
    visible card; one card: a ``(1,)`` mesh, the same sharded code) under
    ``fleet_sweep`` of ``mnist_net()`` (tails/1mF adaptive, charge cv
    0.25) over 16,387 lanes with ``reduce="none"``, ``"stats"`` and
    ``"stats"`` in 4,096-lane chunks, and ``capacitor_sweep`` of 5
    capacitors x 1,024 devices with ``reduce="stats"``: each held against
    the same call without ``mesh=``, the launches of both kernels counted
    from just before each meshed run to just after (one a shard and
    chunk).  A one-shard mesh must be bitwise equal; with more than one
    card, a ``(1,)`` mesh runs first and the mesh over every card is held
    to the multi-shard rule (``reduce="none"`` bitwise; statistics:
    counts, histograms and extremes exact, f64 sums to rtol 1e-12).
    Returns the launches of the meshed runs."""
    from repro_torch.kernels import stats_fold as sf
    from repro_torch.launch.mesh import make_fleet_mesh, mesh_chips

    meshes = [make_fleet_mesh()]
    if mesh_chips(meshes[0]) > 1:
        meshes.insert(0, make_fleet_mesh(1))
    else:
        emit({"phase": "mesh", "multi_card": "one card is visible: the "
              "mesh over every card is the (1,) mesh"})
    kw = dict(plan=plan_tails, n_devices=MESH_LANES, seed=42,
              charge_cv=0.25, charge_reboots=64, trace_reboots=16,
              policy="adaptive", theta=0.5, batch_rows=4, belief_alpha=0.2,
              device="cuda")
    pplan = fleetsim.build_plan(net, x, "tails", "1mF", parametric=True)
    cap_kw = dict(plan=pplan, n_devices=MESH_CAP_DEVICES, seed=5,
                  charge_cv=0.25, charge_reboots=64, reduce="stats",
                  device="cuda")
    chunks = -(-MESH_LANES // MESH_CHUNK)
    runs = (("fleet_sweep/none", False, {}, 1),
            ("fleet_sweep/stats", False, dict(reduce="stats"), 1),
            (f"fleet_sweep/stats/lane_chunk={MESH_CHUNK}", False,
             dict(reduce="stats", lane_chunk=MESH_CHUNK), chunks),
            ("capacitor_sweep/stats", True, {}, 1))

    def call(cap, extra, **more):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if cap:
            r = fleetsim.capacitor_sweep(None, None, CAP_SWEEP, **cap_kw,
                                         **more)
        else:
            r = fleetsim.fleet_sweep(**kw, **extra, **more)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    def differ(a, b, exact: bool) -> list:
        if not hasattr(a, "sums"):
            return arrays_differ(np, a, b, GRID_ARRAYS if isinstance(
                a, fleetsim.CapacitorSweepResult) else SWEEP_ARRAYS)
        if exact:
            return stats_equal(np, a, b)
        bad = [f for f in ("count", "completed")
               if not np.array_equal(getattr(a, f), getattr(b, f))]
        for f in ("hists", "mins", "maxs", "sums", "sumsqs"):
            for ch, v in getattr(a, f).items():
                w = getattr(b, f)[ch]
                if not (np.allclose(v, w, rtol=1e-12, atol=0.0)
                        if f in ("sums", "sumsqs")
                        else np.array_equal(v, w)):
                    bad.append((f, ch))
        if not np.allclose(a.class_sums, b.class_sums, rtol=1e-12,
                           atol=0.0):
            bad.append("class_sums")
        return bad

    totals = {"charge_replay": 0, "stats_fold": 0}
    for m in meshes:
        shards = mesh_chips(m)
        for label, cap, extra, per_shard in runs:
            plain, plain_s = call(cap, extra)
            sf.stats_fold.launches = 0       # just before the meshed run
            zero_counts(wrapper)
            got, mesh_s = call(cap, extra, mesh=m)
            launches = {"charge_replay": wrapper.launches,  # just after
                        "stats_fold": sf.stats_fold.launches}
            stats = cap or "reduce" in extra
            want = {"charge_replay": per_shard * shards,
                    "stats_fold": per_shard * shards if stats else 0}
            if launches != want or wrapper.launches_by_design["direct"]:
                raise SystemExit(f"mesh: {label} over {shards} shards "
                                 f"launched {launches}, expected {want}")
            bad = differ(got, plain, exact=shards == 1 or not stats)
            if bad:
                raise SystemExit(f"mesh: {label} over {shards} shards != "
                                 f"the unmeshed call on {bad}")
            for k, v in launches.items():
                totals[k] += v
            emit({"phase": "mesh", "run": label, "shards": shards,
                  "lanes": len(CAP_SWEEP) * MESH_CAP_DEVICES if cap
                  else MESH_LANES, "wall_s": mesh_s,
                  "unmeshed_wall_s": plain_s, "launches": launches,
                  "rule": "bitwise" if shards == 1 or not stats
                  else "multi-shard"})
    return totals


class CpuWorker:
    """``fn(dir, *inputs)``, a function of this script, run on the CPU in a
    process of its own (``CUDA_VISIBLE_DEVICES=""``, 2 threads) beside the
    card's phases: the inputs and the result pass as pickles through a
    directory under ``build/`` (``self.dir``), where ``fn`` may also leave
    files for the caller.  Every worker still running when the script
    ends is killed (``stop_workers``)."""
    live: list = []

    def __init__(self, fn: str, *inputs):
        import pickle
        import tempfile

        build = ROOT / "build"
        build.mkdir(exist_ok=True)
        self.fn = fn
        self.dir = Path(tempfile.mkdtemp(dir=build, prefix=f"{fn}-"))
        (self.dir / "in.pkl").write_bytes(pickle.dumps(inputs))
        self.log = open(self.dir / "log", "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]"
             "); import chip_smoke; chip_smoke.cpu_worker_main(*sys.argv[2:])",
             str(ROOT), fn, str(self.dir)],
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), stdout=self.log,
            stderr=subprocess.STDOUT)
        CpuWorker.live.append(self)

    def result(self, timeout: float = 900) -> tuple:
        """(what ``fn`` returned, the seconds waited for it)."""
        import pickle

        t0 = time.perf_counter()
        try:
            self.proc.wait(timeout=timeout)
        finally:
            self.stop()
        waited = time.perf_counter() - t0
        if self.proc.returncode != 0:
            raise SystemExit(f"{self.fn}: the CPU worker exited "
                             f"{self.proc.returncode}: {self.tail()}")
        out = pickle.loads((self.dir / "out.pkl").read_bytes())
        shutil.rmtree(self.dir, ignore_errors=True)
        return out, waited

    def tail(self) -> str:
        return (self.dir / "log").read_text()[-3000:]

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()
        if self in CpuWorker.live:
            CpuWorker.live.remove(self)


def stop_workers() -> None:
    for w in list(CpuWorker.live):
        w.stop()


def cpu_worker_main(fn: str, d: str) -> None:
    """A :class:`CpuWorker`'s process: ``fn(dir, *inputs)`` on the CPU."""
    import pickle

    import torch

    torch.set_num_threads(2)
    sys.path.insert(0, str(ROOT / "src"))
    d = Path(d)
    out = globals()[fn](d, *pickle.loads((d / "in.pkl").read_bytes()))
    (d / "out.pkl.tmp").write_bytes(pickle.dumps(out))
    os.replace(d / "out.pkl.tmp", d / "out.pkl")


#: Phase 5h (``paper_demo``): the paper's end-to-end demonstration,
#: ``examples/PAPER_EXAMPLE`` in its own process on the card (PAPER_TIMEOUT s
#: at most) at ``--scale PAPER_SCALE``: every device count a tenth of the
#: JAX example's (100, 26, 6 a candidate and 100,000), since at 1.0 its
#: million-device query alone takes some 230 s of closed-form scan on an
#: H100 (123 chunks of 5,473 rows); ``tools/smoke_phases.py paper_demo``
#: runs it at 1.0.  Beside it, in this process, the Fig. 9 matrix and the design
#: space's PlanSet sweep on the card against ``device="cpu"`` (the CPU
#: halves in a worker process started after the build), and the stats
#: query's call at PAPER_PEAK_LANES lanes for its peak lane buffer.  The design space's
#: check runs PAPER_DESIGN_DEVICES devices a candidate, not the example's
#: 64: the CPU's plain event stream takes 190-230 s on the H100 machine's
#: host over its longest plan (63,489 Tile-8 rows) at any lane count.
PAPER_EXAMPLE = "intermittent_mnist_torch.py"
PAPER_SCALE = 0.1
PAPER_TIMEOUT = 900
PAPER_DESIGN_DEVICES = 8
PAPER_PEAK_LANES = 65536


def load_example(name: str):
    """``examples/name`` imported as a module (its sections are
    functions)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        Path(name).stem, ROOT / "examples" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def paper_cpu_reference(d: Path, orig, net, x, devices: int) -> dict:
    """The CPU halves of ``paper_demo``'s checks (a :class:`CpuWorker`):
    the design space built as the example builds it (pickled to
    ``d / "planset.pkl"`` at once, for the card's run) and swept on the
    CPU at ``devices`` a candidate, then the Fig. 9 matrix
    (``fleet_evaluate(device="cpu")``)."""
    import pickle

    from repro_torch.core import fleet_evaluate

    ex = load_example(PAPER_EXAMPLE)
    t0 = time.perf_counter()
    design = ex.design_plans(orig, net, x)
    build_s = time.perf_counter() - t0
    (d / "planset.tmp").write_bytes(pickle.dumps(design))
    os.replace(d / "planset.tmp", d / "planset.pkl")
    t0 = time.perf_counter()
    rows = ex.design_sweep(design, devices, "cpu").summary()
    design_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cells = fleet_evaluate(net, x, device="cpu")
    return dict(rows=rows, cells=cells, design_build_s=build_s,
                design_s=design_s, matrix_s=time.perf_counter() - t0)


def start_paper_reference() -> tuple:
    """The demonstration's nets and input -- ``mnist_net()``, its GENESIS
    compression (not retrained) and the stand-in task's first test input
    (``make_task``'s data depend on the process's hash seed, so it is made
    here once) -- and the :class:`CpuWorker` computing the CPU halves of
    ``paper_demo``'s checks on them."""
    from repro_torch.data import make_task
    from repro_torch.models.dnn import mnist_net

    ex = load_example(PAPER_EXAMPLE)
    task = make_task("mnist", n_train=512, n_test=256, noise=0.85)
    inputs = (mnist_net(), ex.compressed_net("mnist"), task.x_test[0])
    return CpuWorker("paper_cpu_reference", *inputs,
                     PAPER_DESIGN_DEVICES), inputs


def run_results_differ(np, a, b) -> list:
    """The fields of two ``RunResult``s that differ in any bit."""
    import dataclasses

    bad = []
    for f in dataclasses.fields(a):
        u, v = getattr(a, f.name), getattr(b, f.name)
        same = np.array_equal(u, v) if isinstance(u, np.ndarray) \
            or isinstance(v, np.ndarray) else u == v
        if not same:
            bad.append(f.name)
    return bad


def paper_demo(torch, np, emit, fleetsim, smi_line, scale=PAPER_SCALE,
               reference=None) -> dict:
    """Phase 5h: the paper's end-to-end demonstration on the card.
    ``examples/intermittent_mnist_torch.py`` runs at ``--scale scale`` in
    its own process: exit code 0, every section's header line, SONIC and
    TAILS finishing on every power system of the Fig. 9 matrix, no wasted
    cycles at charge cv 0 and some at cv 0.8, exactly one plan-mode launch
    of the lane kernel for the 15 candidates, and a peak lane buffer equal
    to that of the same call over PAPER_PEAK_LANES lanes here.  While it
    runs (its section walls are taken beside them), this process computes
    the card's halves of two checks whose CPU halves ``reference`` (from
    :func:`start_paper_reference`; started here if None) computes in a
    worker process: the Fig. 9 matrix of the compressed net (the
    closed-form scan; all 24 ``RunResult``s bitwise) and the design
    space's PlanSet sweep at PAPER_DESIGN_DEVICES a candidate (the lane
    kernel in plan mode; the ``summary()`` rows bitwise).  Returns the
    example's launches of the lane kernel (by row mode) and the
    statistics fold, its section walls and the checks' seconds."""
    import pickle

    from repro_torch.kernels import closed_form as cf

    t_phase = time.perf_counter()
    worker, (orig, net, x) = reference or start_paper_reference()
    ex = load_example(PAPER_EXAMPLE)
    build = ROOT / "build"
    emit({"phase": "paper_demo", "nvidia_smi": smi_line,
          "example": f"examples/{PAPER_EXAMPLE}", "scale": scale,
          "reduced": None if scale == 1.0 else
          f"every device count x {scale} (the JAX example's at 1.0)",
          "design_devices_checked": PAPER_DESIGN_DEVICES,
          "peak_lanes_checked": PAPER_PEAK_LANES})
    # the example in its own process; the card's halves of the checks
    # meanwhile in this one
    log_path = build / "paper_demo_example.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        example = subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / PAPER_EXAMPLE),
             "--scale", str(scale)], stdout=log, stderr=subprocess.STDOUT,
            text=True)
    try:
        # the peak run first, on the card while the example builds its
        # plans on the host, then the matrix's plan builds while its scan
        cf.closed_form.launches = 0       # just before the peak run
        t1 = time.perf_counter()
        peak = fleetsim.fleet_sweep(
            net, x, "sonic", "1mF", n_devices=PAPER_PEAK_LANES, seed=42,
            reduce="stats", lane_chunk=ex.QUERY_CHUNK,
            device="cuda").peak_lane_bytes
        peak_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        cells = fleetsim.fleet_evaluate(net, x, device="cuda")
        matrix_s = time.perf_counter() - t1
        closed_here = cf.closed_form.launches   # just after the matrix
        planset = worker.dir / "planset.pkl"
        while not planset.exists() and worker.proc.poll() is None:
            time.sleep(1.0)
        if not planset.exists():
            raise SystemExit(f"paper_demo: the CPU worker wrote no PlanSet: "
                             f"{worker.tail()}")
        design = pickle.loads(planset.read_bytes())
        t1 = time.perf_counter()
        rows = ex.design_sweep(design, PAPER_DESIGN_DEVICES,
                               "cuda").summary()
        design_s = time.perf_counter() - t1
        example.wait(timeout=PAPER_TIMEOUT)
    finally:
        if example.poll() is None:
            example.kill()
            example.wait()
    example_s = time.perf_counter() - t0
    out = log_path.read_text()
    if example.returncode != 0:
        raise SystemExit(f"paper_demo: examples/{PAPER_EXAMPLE} exited "
                         f"{example.returncode}: {out[-4000:]}")
    checks = paper_output_checks(out.splitlines(), ex)
    emit({"phase": "paper_demo", "part": "example", "seconds": example_s,
          **checks, "output": "build/paper_demo_example.log"})
    cpu, wait_s = worker.result(timeout=PAPER_TIMEOUT)
    bad = {f"{c.strategy}/{c.power}": run_results_differ(np, c, w)
           for c, w in zip(cells, cpu["cells"])}
    bad = {k: v for k, v in bad.items() if v}
    if len(cells) != 24 or len(cpu["cells"]) != 24 or bad:
        raise SystemExit(f"paper_demo: the Fig. 9 matrix on the card != "
                         f"the CPU's: {bad}")
    if rows != cpu["rows"] or len(rows) != len(design):
        raise SystemExit(f"paper_demo: the design space on the card != the "
                         f"CPU's: {rows} against {cpu['rows']}")
    printed = f"{peak / 1e6:.1f}"
    if checks["peak_lane_buffer_mb"] != printed:
        raise SystemExit(f"paper_demo: the query's peak lane buffer "
                         f"{checks['peak_lane_buffer_mb']} MB != "
                         f"{printed} MB at {PAPER_PEAK_LANES} lanes")
    closed = {"example": checks["launches"]["closed_form"],
              "peak_and_matrix": closed_here}
    if not all(closed.values()):
        raise SystemExit(f"paper_demo: the closed form's kernel launched "
                         f"{closed}, not on every part")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "paper_demo", "matrix_bitwise_equal_cpu": True,
          "matrix_cells": 24, "matrix_s": matrix_s,
          "cpu_matrix_s": cpu["matrix_s"],
          "design_rows_bitwise_equal_cpu": True,
          "design_candidates": len(rows),
          "design_devices": PAPER_DESIGN_DEVICES, "design_s": design_s,
          "cpu_design_s": cpu["design_s"],
          "cpu_design_build_s": cpu["design_build_s"],
          "peak_lane_bytes": peak, "peak_lanes": PAPER_PEAK_LANES,
          "peak_s": peak_s, "cpu_worker_wait_s": wait_s,
          "example_s": example_s, "seconds": seconds, "all_agree": True,
          "closed_form_launches": closed, "nvidia_smi": smi_line})
    return dict(checks, seconds=seconds,
                closed_form_launches=sum(closed.values()))


def paper_output_checks(lines: list, ex) -> dict:
    """The paper's invariants, read from the example's output ``lines``:
    every header of ``ex.HEADERS`` in order; SONIC and TAILS finish on
    every power system of the matrix; the risk table's two cross-charge
    waste columns 0 at charge cv 0 and above 0 at cv 0.8; one plan-mode
    launch for the design space; the peak lane buffer, the section walls
    and the kernel launches.  Raises SystemExit on a broken invariant."""
    at = []
    for h in ex.HEADERS:
        hits = [i for i, ln in enumerate(lines) if h in ln]
        if not hits:
            raise SystemExit(f"paper_demo: no {h!r} line in the output")
        at.append(hits[0])
    if at != sorted(at):
        raise SystemExit(f"paper_demo: the sections are out of order: {at}")
    table = lines[at[1]:at[1] + 1 + len(ex.STRATEGIES)]
    finish = {}
    for strat in ("sonic", "tails"):
        row = [ln for ln in table if ln.split()[:1] == [strat]]
        if len(row) != 1 or "DNF" in row[0] \
                or row[0].count(" ms") != len(ex.POWER_SYSTEMS):
            raise SystemExit(f"paper_demo: {strat} does not finish on every "
                             f"power system: {row}")
        finish[strat] = row[0].strip()
    waste = {}
    for ln in lines[at[5] + 2:at[5] + 2 + len(ex.RISK_CVS)]:
        f = ln.split()
        waste[float(f[0])] = (float(f[5]), float(f[6]))
    if sorted(waste) != list(ex.RISK_CVS) or waste[0.0] != (0.0, 0.0) \
            or not min(waste[0.8]) > 0:
        raise SystemExit(f"paper_demo: wasted cycles by charge cv {waste}: "
                         f"not 0 at cv 0 and above 0 at cv 0.8")
    launches = re.search(r"plan-mode launches=(\d+)", lines[at[4]])
    if launches is None or int(launches.group(1)) != 1:
        raise SystemExit(f"paper_demo: the design space took "
                         f"{lines[at[4]]!r}, not one plan-mode launch")
    peak = [re.search(r"peak lane buffer: ([\d.]+) MB", ln) for ln in lines]
    peak = [m.group(1) for m in peak if m]
    walls = [ln for ln in lines if ln.startswith("section walls: ")]
    counts = [ln for ln in lines if ln.startswith("kernel launches: ")]
    if len(peak) != 1 or len(walls) != 1 or len(counts) != 1:
        raise SystemExit("paper_demo: no peak lane buffer, section walls or "
                         "kernel launches line")
    wall_s = {k: float(v.rstrip("s")) for k, v in (
        kv.split("=") for kv in walls[0][len("section walls: "):]
        .split(", "))}
    launched = {k: int(v) for k, v in (
        kv.split("=") for kv in counts[0][len("kernel launches: "):]
        .split(", "))}
    return {"headers_found": len(at), "finish": finish,
            "waste_by_cv": {str(k): v for k, v in waste.items()},
            "design_plan_mode_launches": 1,
            "peak_lane_buffer_mb": peak[0], "section_walls_s": wall_s,
            "launches": launched,
            "query": [ln.strip() for ln in lines[at[6]:at[6] + 5]]}


#: Phase 5e: GENESIS end to end -- the JAX benchmark's fig4_5 MNIST call
#: (``benchmarks/paper_figs.py``: ``make_task("mnist", n_train=768,
#: n_test=256, noise=0.85)``, 2 epochs, 10 configurations) at MNIST's
#: published widths, and its svm_vs_dnn MNIST pair.
GENESIS_TASK = dict(n_train=768, n_test=256, noise=0.85)
GENESIS_EPOCHS = 2
GENESIS_CONFIGS = 10
SVM_TASK = dict(n_train=768, n_test=256, noise=0.6, sign_flip=True)
SVM_DNN_EPOCHS = 3
#: The card's training against the CPU's over the first 8 steps from the
#: same weights and batches, held on float64 weights and inputs, where the
#: two devices' convolutions and products agree to float64 rounding (the
#: optimizer still steps in f32, as the JAX module does): the rule the CPU
#: tests hold the port to against the JAX package.  In float32 a max-pool
#: or ReLU decision that one rounding flips, or a gradient near AdamW's
#: eps, makes a step differ by up to the learning rate, so the float32
#: run's distance (each layer's update against the CPU run's, in the
#: 2-norm) is reported, not held.
TRAIN_STEPS = 8
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-5


def compressed_mnist(gen, net):
    """The JAX benchmark's ``compressed_net("mnist")``: the first conv
    separated, the deep conv pruned to 90 %, the large dense layers pruned
    to 95 % and 90 %, the last kept."""
    Conv2D, DenseFC = type(net.layers[0]), type(net.layers[-1])
    choices = []
    for layer in net.layers:
        if isinstance(layer, Conv2D):
            co, ci, kh, kw = layer.w.shape
            choices.append(gen.LayerChoice(
                "separate", max(2, min(ci * kh, co * kw) // 6)) if ci == 1
                else gen.LayerChoice("prune", 0.9))
        elif isinstance(layer, DenseFC) and layer.w.size > 20_000:
            choices.append(gen.LayerChoice("prune", 0.95))
        elif isinstance(layer, DenseFC) and layer.w.size > 4_000:
            choices.append(gen.LayerChoice("prune", 0.9))
        else:
            choices.append(gen.LayerChoice("keep"))
    return gen.apply_config(net, tuple(choices))


def genesis(torch, np, emit, fleetsim, cr, wrapper, defer=False) -> dict:
    """Phase 5e: GENESIS through the port on the card -- ``sweep`` (every
    candidate retrained, the grid priced by one ``fleet_sweep`` of a
    ``PlanSet``: the lane kernel in plan mode over all-nominal charges,
    then the statistics fold), ``pareto_frontier`` and ``select``, then
    the SVM-against-DNN pair (its DNN priced by ``estimate_energy``'s
    one-lane replay: the closed-form scan).  The card's first 8 training
    steps are held against the CPU's; the closed-form scan is timed on
    the sweep's PlanSet.  The pricing and that scan are held bitwise
    against the same sweep and scan on the CPU, run by a
    :class:`CpuWorker` beside the card: with ``defer`` the line returned
    carries it as ``"cpu_reference"`` for :func:`genesis_cpu_check`, else
    the check is made before returning.  Returns the phase's line, with
    the launches counted from just before the sweep to just after."""
    import copy
    import dataclasses

    from repro_torch.compress import genesis as gen
    from repro_torch.compress import svm_baseline, train_small
    from repro_torch.core import WILDLIFE
    from repro_torch.core.imp import AppModel
    from repro_torch.data import make_task
    from repro_torch.kernels import closed_form as cf
    from repro_torch.kernels import stats_fold as sf
    from repro_torch.models.dnn import mnist_net

    seconds = {"train": 0.0, "class_rates": 0.0, "build_plan": 0.0,
               "fleet_sweep": 0.0}
    priced = []
    real = {(mod, n): getattr(mod, n) for mod, n in (
        (train_small, "train"), (train_small, "class_rates"),
        (fleetsim, "build_plan"), (fleetsim, "fleet_sweep"))}

    def timed(mod, name):
        fn = real[(mod, name)]

        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            seconds[name] += time.perf_counter() - t
            if name == "fleet_sweep":
                priced.append((k, out))
            return out
        return run

    net = mnist_net()
    data = make_task("mnist", **GENESIS_TASK)
    rec = Recorder(torch, wrapper)
    try:
        for mod, n in real:
            setattr(mod, n, timed(mod, n))
        cr.charge_replay = rec
        sf.stats_fold.launches = 0        # just before the sweep
        cf.closed_form.launches = 0
        zero_counts(wrapper)
        t0 = time.perf_counter()
        results = gen.sweep(net, data, WILDLIFE, epochs=GENESIS_EPOCHS,
                            max_configs=GENESIS_CONFIGS, device="cuda")
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        fold_launches = sf.stats_fold.launches      # read just after
        closed_launches = {"pricing": cf.closed_form.launches}
        lane_launches = wrapper.launches
        by_mode = dict(wrapper.launches_by_mode)
        by_design = dict(wrapper.launches_by_design)
    finally:
        for (mod, n), fn in real.items():
            setattr(mod, n, fn)
        cr.charge_replay = wrapper
    if fold_launches != 1 or len(priced) != 1 or len(rec.calls) != 1:
        raise SystemExit(f"genesis: the pricing folded {fold_launches} "
                         f"times over {len(priced)} sweeps and "
                         f"{len(rec.calls)} replays, not once")
    if lane_launches != 1 or by_mode["plan"] != 1 \
            or by_design["hoisted"] != 1:
        raise SystemExit(f"genesis: the pricing launched {by_design} in "
                         f"modes {by_mode}, not the hoisted design once in "
                         f"plan mode")
    front = gen.pareto_frontier(results)
    if not front:
        raise SystemExit("genesis: empty Pareto frontier")
    best = gen.select(results)
    if best.params_bytes > gen.DEVICE_WEIGHT_BYTES:
        raise SystemExit(f"genesis: select chose {best.params_bytes} B of "
                         f"weights, over {gen.DEVICE_WEIGHT_BYTES}")
    accs = [r.accuracy for r in front]
    if accs != sorted(accs):
        raise SystemExit("genesis: the frontier's accuracy falls with energy")
    call = rec.calls[0]
    ev0, ev1 = call["events"]
    pricing_kernel_ms = ev0.elapsed_time(ev1)

    kw, st = priced[0]
    for g, r in enumerate(results):
        if r.completion > 0 and r.e_infer_j != gen.estimate_energy(
                r.net, stats=st, group=g, device="cuda"):
            raise SystemExit(f"genesis: estimate_energy(stats=) != "
                             f"e_infer_j of candidate {g}")

    emit({"phase": "genesis", "sweep_s": sweep_s,
          "pricing_kernel_ms": pricing_kernel_ms, "seconds": dict(seconds)})

    # the closed-form scan over the sweep's PlanSet and lanes (its charges
    # the nominal ones), 5 runs between CUDA events
    a, k = call["args"], call["kw"]
    scan_args = (a[0], a[1], a[2], a[3], a[4], a[8], k["conf"], k["radio"])
    scan_kw = dict(adaptive=k["adaptive"], parametric=k["parametric"],
                   shared_rows=k["shared_rows"], has_send=k["has_send"],
                   plan_idx=k["plan_idx"])
    times = []
    for _ in range(5):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        scan_out = fleetsim._scan_replay(*scan_args, **scan_kw)
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
    scan_ms = sorted(times)[2]
    if not bool(torch.isfinite(scan_out["live"]).all()):
        raise SystemExit("genesis: the closed-form scan gave non-finite "
                         "live cycles")
    table = a[0].packed
    # the pricing (the plain event stream and the plain fold) and the scan
    # (the CPU's loop against the card's kernel) on the CPU
    rows_cpu = copy.copy(a[0])
    rows_cpu.packed, rows_cpu.hoisted = table.cpu(), None
    reference = CpuWorker(
        "genesis_cpu_reference", dict(kw, device="cpu"), rows_cpu,
        (*(v.cpu() for v in scan_args[1:5]), scan_args[5],
         *(v.cpu() for v in scan_args[6:])),
        dict(scan_kw, plan_idx=scan_kw["plan_idx"].cpu()))
    pending = {"worker": reference, "stats": st,
               "scan": {k: v.cpu() for k, v in scan_out.items()}}

    # the card's first 8 training steps against the CPU's, same weights
    # and batches: held in float64, reported in float32
    cnet = gen.apply_config(net, best.choices)
    batch = GENESIS_TASK["n_train"] // TRAIN_STEPS
    net64 = type(cnet)([dataclasses.replace(
        l, **{k: getattr(l, k).astype(np.float64) for k in ("w", "b")})
        if hasattr(l, "w") else l for l in cnet.layers], cnet.input_shape,
        cnet.name)
    data64 = dataclasses.replace(
        data, x_train=data.x_train.astype(np.float64),
        x_test=data.x_test.astype(np.float64))
    steps = []
    for dtype, n_, d_ in (("float64", net64, data64),
                          ("float32", cnet, data)):
        on_card, _ = train_small.train(n_, d_, epochs=1, batch=batch,
                                       device="cuda")
        on_cpu, _ = train_small.train(n_, d_, epochs=1, batch=batch,
                                      device="cpu")
        for i, (lc, lh, l0) in enumerate(zip(on_card.layers, on_cpu.layers,
                                             n_.layers)):
            if not hasattr(l0, "w"):
                continue
            d_card = np.concatenate([(lc.w - l0.w).ravel(), lc.b - l0.b])
            d_cpu = np.concatenate([(lh.w - l0.w).ravel(), lh.b - l0.b])
            pruned = l0.w == 0
            steps.append({
                "dtype": dtype, "layer": i, "kind": type(l0).__name__,
                "update_rel_diff": float(np.linalg.norm(d_card - d_cpu)
                                         / np.linalg.norm(d_cpu)),
                "max_abs_diff": float(np.abs(d_card - d_cpu).max()),
                "max_abs_update": float(np.abs(d_cpu).max()),
                "within_rule": bool(
                    np.allclose(lc.w, lh.w, rtol=TRAIN_RTOL,
                                atol=TRAIN_ATOL)
                    and np.allclose(lc.b, lh.b, rtol=TRAIN_RTOL,
                                    atol=TRAIN_ATOL)),
                "pruned_zeros_kept": bool((lc.w[pruned] == 0).all()
                                          and (lh.w[pruned] == 0).all())})
    emit({"phase": "genesis", "train_vs_cpu": steps,
          "choices": [(c.kind, c.arg) for c in best.choices],
          "steps": TRAIN_STEPS, "batch": batch,
          "rule": f"float64: rtol {TRAIN_RTOL}, atol {TRAIN_ATOL}; both "
                  f"dtypes: pruned zeros kept"})
    for st_ in steps:
        if not st_["pruned_zeros_kept"] or (
                st_["dtype"] == "float64" and not st_["within_rule"]):
            raise SystemExit(f"genesis: layer {st_['layer']} after "
                             f"{TRAIN_STEPS} steps on the card != the CPU's: "
                             f"{st_}")

    # svm_vs_dnn's MNIST pair, on the sign-flipped task
    task = make_task("mnist", **SVM_TASK)
    t0 = time.perf_counter()
    w, b, svm_acc = svm_baseline.train_svm(task, device="cuda")
    svm = svm_baseline.svm_impj(w, b, task, WILDLIFE)
    svm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dnn, dnn_acc = train_small.train(compressed_mnist(gen, net), task,
                                     epochs=SVM_DNN_EPOCHS, device="cuda")
    tp, tn = train_small.class_rates(dnn, task, 0, device="cuda")
    dnn_train_s = time.perf_counter() - t0
    cf.closed_form.launches = 0           # just before the DNN's pricing
    t0 = time.perf_counter()
    e_dnn = gen.estimate_energy(dnn, device="cuda")
    energy_s = time.perf_counter() - t0
    closed_launches["estimate_energy"] = cf.closed_form.launches  # after
    if closed_launches["estimate_energy"] != 1:
        raise SystemExit(f"genesis: estimate_energy launched the closed "
                         f"form {closed_launches['estimate_energy']} times, "
                         f"not once")
    dnn_impj = AppModel(WILDLIFE.p, WILDLIFE.e_sense, WILDLIFE.e_comm,
                        e_dnn).inference(tp, tn)
    pair = [svm["impj"], svm_acc, dnn_impj, dnn_acc, e_dnn]
    if not all(np.isfinite(pair)) or e_dnn <= 0:
        raise SystemExit(f"genesis: svm_vs_dnn gave {pair}")

    line = {"phase": "genesis", "network": "mnist_net() (Table 2 widths)",
            "task": GENESIS_TASK, "epochs": GENESIS_EPOCHS,
            "configs": len(results),
            "PYTHONHASHSEED": os.environ.get("PYTHONHASHSEED", "unset"),
            "sweep_s": sweep_s, "train_s": seconds["train"],
            "class_rates_s": seconds["class_rates"],
            "plan_build_s": seconds["build_plan"],
            "pricing_s": seconds["fleet_sweep"],
            "pricing_kernel_ms": pricing_kernel_ms,
            "pricing_lanes": int(a[1].shape[0]),
            "planset_table_shape": list(table.shape),
            "lane_kernel_launches": lane_launches,
            "lane_kernel_launches_by_mode": by_mode,
            "stats_fold_launches": fold_launches,
            "closed_form_launches": sum(closed_launches.values()),
            "closed_form_launches_by_run": closed_launches,
            "closed_form_scan_ms": scan_ms, "closed_form_scan_runs_ms": times,
            "closed_form_scan_rows": int(table.shape[1]),
            "closed_form_scan_ms_per_row": scan_ms / table.shape[1],
            "frontier": [{"choices": [(c.kind, c.arg) for c in r.choices],
                          "accuracy": r.accuracy, "e_infer_j": r.e_infer_j,
                          "params_bytes": r.params_bytes, "impj": r.impj}
                         for r in front],
            "completion": [r.completion for r in results],
            "selected": {"choices": [(c.kind, c.arg) for c in best.choices],
                         "impj": best.impj,
                         "params_bytes": best.params_bytes,
                         "accuracy": best.accuracy,
                         "e_infer_j": best.e_infer_j,
                         "latency_s": best.latency_s},
            "train_steps_vs_cpu": TRAIN_STEPS,
            "train_update_rel_diff_vs_cpu": {
                dt: max(x["update_rel_diff"] for x in steps
                        if x["dtype"] == dt)
                for dt in ("float64", "float32")},
            "svm_vs_dnn": {"svm_impj": svm["impj"], "svm_acc": svm_acc,
                           "svm_s": svm_s, "dnn_impj": dnn_impj,
                           "dnn_acc": dnn_acc, "dnn_train_s": dnn_train_s,
                           "dnn_e_infer_j": e_dnn,
                           "estimate_energy_s": energy_s}}
    emit(line)
    if defer:
        return dict(line, cpu_reference=pending)
    genesis_cpu_check(torch, np, emit, pending)
    return line


def genesis_cpu_reference(d: Path, kw: dict, rows, scan_args: tuple,
                          scan_kw: dict) -> dict:
    """The CPU halves of ``genesis``'s pricing and closed-form checks (a
    :class:`CpuWorker`): the pricing sweep's ``fleet_sweep`` call on the
    CPU, and ``_scan_replay`` over its PlanSet's lanes."""
    from repro_torch.core import fleetsim

    t0 = time.perf_counter()
    st = fleetsim.fleet_sweep(**kw)
    pricing_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scan = fleetsim._scan_replay(rows, *scan_args, **scan_kw)
    return dict(stats=st, scan=scan, pricing_s=pricing_s,
                scan_s=time.perf_counter() - t0)


def genesis_cpu_check(torch, np, emit, pending: dict) -> None:
    """``genesis``'s pricing and closed-form scan on the card against the
    CPU's (``pending``: the worker and the card's results), bitwise."""
    cpu, waited = pending["worker"].result()
    st, st_cpu = pending["stats"], cpu["stats"]
    for what, a, b in (
            ("completion", st.completion_rate, st_cpu.completion_rate),
            ("mean live_cycles", st.mean("live_cycles"),
             st_cpu.mean("live_cycles")),
            ("mean total_s", st.mean("total_s"), st_cpu.mean("total_s"))):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise SystemExit(f"genesis: the card's {what} != the CPU's")
    bad = stats_equal(np, st, st_cpu)
    if bad:
        raise SystemExit(f"genesis: the card's statistics != the CPU's on "
                         f"{bad}")
    ok, _err, bad = compare(torch, pending["scan"], cpu["scan"])
    if not ok:
        raise SystemExit(f"genesis: the closed-form scan on the card != the "
                         f"CPU's on {bad}")
    emit({"phase": "genesis", "part": "cpu_reference",
          "pricing_bitwise_equal_cpu": True, "cpu_pricing_s":
          cpu["pricing_s"], "closed_form_scan_bitwise_equal_cpu": True,
          "closed_form_scan_cpu_s": cpu["scan_s"], "waited_s": waited})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import fleetsim
    from repro_torch.core.energy import custom_power_system, \
        rf_recharge_seconds
    from repro_torch.core.inference import (Conv2D, DenseFC, MaxPool2D,
                                            SimNet, SparseFC)
    from repro_torch.kernels import _build
    from repro_torch.kernels import charge_replay as cr
    from repro_torch.models.dnn import har_net, mnist_net
    from repro_torch.runtime.failures import (charge_capacity_jitter,
                                              reboot_recharge_times)
    from repro_torch.runtime.radio import (RadioModel, SEND_POLICIES,
                                           pack_radio)

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device
    device_name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "not measured"
    emit({"phase": "device", "name": device_name, "count": count,
          "nvidia_smi": smi_line, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 2. build every kernel of the path
    built = _build.build("charge_replay", "closed_form", "stats_fold",
                         "dense_matmul", "sparse_fc", "fir_conv1d",
                         "flash_attention", "ssd_intra",
                         "ssd_intra_thread_fed")
    for b in built.values():
        ptxas = [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln or "stack" in ln]
        emit({"phase": "build", "kernel": b.name, "seconds": b.seconds,
              "flags": " ".join(_build.SOURCE_FLAGS[b.name]), "ptxas": ptxas})
    # the lane kernel's designs (and instantiations) and the narrow matmul:
    # registers, spill bytes and stack frame
    emit({"phase": "build", "kernel": "charge_replay", "lane_kernels":
          ptxas_by_kernel(built["charge_replay"].log)})
    emit({"phase": "build", "kernel": "closed_form", "closed_form_kernels":
          ptxas_by_kernel(built["closed_form"].log)})
    emit({"phase": "build", "kernel": "dense_matmul", "narrow_kernels": {
        n: r for n, r in ptxas_by_kernel(built["dense_matmul"].log).items()
        if "matmul_narrow_kernel" in n}})
    # the Hopper kernels: registers and spills, and wgmma and TMA in the SASS
    cuobjdump = cuobjdump_path()
    if cuobjdump is None:
        emit({"phase": "build", "sass": "cuobjdump is not in the toolkit: "
              "the HGMMA and UTMALDG counts are not checked"})
    hopper = {}
    for source, kernels in WGMMA_KERNELS.items():
        regs = {n: r for n, r in ptxas_by_kernel(built[source].log).items()
                if any(k in n for k in kernels)}
        sass = {} if cuobjdump is None else {
            n: c for n, c in sass_counts(cuobjdump, built[source].path
                                         ).items()
            if any(k in n for k in kernels)}
        for kernel in kernels:
            if not any(kernel in n for n in regs):
                raise SystemExit(f"build: no ptxas report of {kernel} in "
                                 f"{source}'s build log")
            if cuobjdump is not None and not any(kernel in n for n in sass):
                raise SystemExit(f"build: no {kernel} in {source}'s SASS")
        for mangled, counts in sass.items():
            if not (counts["HGMMA"] and counts["UTMALDG"]):
                raise SystemExit(f"build: {mangled} has {counts} in its "
                                 f"SASS: no wgmma or no TMA load")
        for mangled, r in regs.items():
            if r.get("spill_stores", 0) or r.get("spill_loads", 0):
                raise SystemExit(f"build: {mangled} spills registers: {r}")
        hopper[source] = {n: dict(regs[n], **sass.get(n, {})) for n in regs}
        emit({"phase": "build", "kernel": source, "hopper_kernels":
              hopper[source]})

    # the CPU halves of paper_demo's checks, beside the card from here on
    paper_reference = start_paper_reference()

    wrapper = cr.charge_replay
    rec = Recorder(torch, wrapper)
    cr.charge_replay = rec
    classes = (Conv2D, DenseFC, MaxPool2D, SimNet, SparseFC)
    max_err = 0.0

    def check_calls(label, calls):
        nonlocal max_err
        for c in calls:
            a, kw = c["args"], c["kw"]
            plain = cr.event_replay(*a, **{k: v for k, v in kw.items()
                                           if k != "host_checked"})
            again = wrapper(*a, **kw)
            direct = wrapper(*a, **kw, design="direct")
            torch.cuda.synchronize()
            for ref_name, ref in (("plain", plain), ("relaunch", again),
                                  ("the direct design", direct)):
                ok, err, bad = compare(torch, c["out"], ref)
                max_err = max(max_err, err)
                if not ok:
                    raise SystemExit(f"{label}: kernel != {ref_name} on "
                                     f"{bad} (max abs diff {err})")

    # ---- 3. kernel against the plain version on small random nets
    def restamp(seed, strat, frac, parametric=False):
        net, x = random_net(seed, classes)
        p = fleetsim.build_plan(net, x, strat, "1mF", parametric=parametric)
        cap = max(2000.0, float(np.rint(frac * p.total_cycles)))
        return fleetsim.dataclasses.replace(
            p, capacity=cap, recharge_s=float(rf_recharge_seconds(cap)))

    def per_lane(plans, policy, theta, w, alpha, cv, n_ch, seed, **kw):
        n = len(plans)
        rng = np.random.default_rng(seed)
        caps = np.asarray([p.capacity for p in plans])
        ctr = charge_capacity_jitter(n, n_ch, caps, seed=seed, cv=cv)
        rtr = reboot_recharge_times(n, 16, plans[0].recharge_s,
                                    seed=seed + 1)
        return fleetsim.replay_plans(
            plans, init_frac=rng.uniform(0.02, 1.0, n), policy=policy,
            theta=theta, batch_rows=w, belief_alpha=alpha,
            charge_traces=ctr, recharge_traces=rtr, **kw)

    def burn_plan():
        net, x = random_net(3, classes)
        for cyc in (2000, 3000, 5000, 8000, 12000):
            p = fleetsim.build_plan(net, x, "tails", custom_power_system(cyc))
            if (p.kind == fleetsim.KIND_BURN).any():
                return p
        raise SystemExit("kernel_vs_plain: no tails plan with BURN rows")

    window = RadioModel(window_period_s=0.05, window_duty=0.3)
    sonic = restamp(0, "sonic", 0.2)
    sonic_small = restamp(1, "sonic", 0.08)
    tile8 = restamp(2, "tile-8", 0.3)
    tails = restamp(1, "tails", 0.15)
    ptails = [restamp(1, "tails", f, parametric=True)
              for f in (0.05, 0.12, 0.3, 0.6)]
    burn = burn_plan()
    net3, x3 = random_net(3, classes)
    policies = (("fixed", 0.5, 1, 0.0), ("adaptive", 0.5, 1, 0.0),
                ("adaptive", 0.5, 4, 0.0), ("adaptive", 0.5, 1, 0.2),
                ("adaptive", 0.25, 4, 0.2))
    cases = []
    for pol in policies:
        for plan, n_ch in ((sonic, 48), (sonic_small, 6), (tile8, 48),
                           (tails, 48)):
            cases.append((f"{plan.strategy}/{pol}/{n_ch}",
                          lambda plan=plan, pol=pol, n_ch=n_ch: per_lane(
                              [plan] * 6, *pol, 0.4, n_ch, seed=n_ch,
                              device="cuda")))
        cases.append((f"tails-param/{pol}",
                      lambda pol=pol: per_lane(ptails * 2, *pol, 0.4, 48,
                                               seed=9, device="cuda")))
        cases.append((f"tails-burn/{pol}",
                      lambda pol=pol: fleetsim.fleet_sweep(
                          plan=burn, n_devices=64, seed=5, charge_cv=0.4,
                          trace_reboots=8, policy=pol[0], theta=pol[1],
                          batch_rows=pol[2], belief_alpha=pol[3],
                          device="cuda")))
        cases.append((f"sonic-radio/{pol}",
                      lambda pol=pol: fleetsim.fleet_sweep(
                          net3, x3, "sonic", "100uF", n_devices=64, seed=3,
                          charge_cv=0.4, trace_reboots=8, policy=pol[0],
                          theta=pol[1], batch_rows=pol[2],
                          belief_alpha=pol[3],
                          radio=pack_radio(window, SEND_POLICIES[1]),
                          device="cuda")))
    design = fleetsim.PlanSet.from_plans([sonic, tile8, tails, burn,
                                          sonic_small])
    for pol in (policies[0], policies[4]):
        cases.append((f"planset/{pol}",
                      lambda pol=pol: fleetsim.fleet_sweep(
                          plan=design, n_devices=12, seed=8, charge_cv=0.4,
                          charge_reboots=24, trace_reboots=8, policy=pol[0],
                          theta=pol[1], batch_rows=pol[2],
                          belief_alpha=pol[3], device="cuda")))
    inf_plan = fleetsim.dataclasses.replace(sonic, capacity=np.inf)
    cases.append(("cap-inf/radio", lambda: per_lane(
        [sonic, inf_plan, sonic, inf_plan], "adaptive", 0.5, 2, 0.1, 0.4, 12,
        seed=4, radio=pack_radio(window, SEND_POLICIES[0]),
        conf=np.array([0.95, 0.5, 0.99, 0.2]), device="cuda")))
    t0 = time.perf_counter()
    n_calls = n_lanes = 0
    flags = set()
    for label, run in cases:
        rec.calls = []
        run()
        torch.cuda.synchronize()
        if not rec.calls:
            raise SystemExit(f"kernel_vs_plain: {label} launched no kernel")
        check_calls(label, rec.calls)
        for c in rec.calls:
            n_calls += 1
            n_lanes += int(c["args"][1].shape[0])
            kw = c["kw"]
            flags.add((kw["adaptive"], kw["parametric"], kw["shared_rows"],
                       kw["enable_fast"], kw["has_burn"], kw["has_send"]))
    for need in ("adaptive", "parametric", "shared_rows", "enable_fast",
                 "has_burn", "has_send"):
        j = ("adaptive", "parametric", "shared_rows", "enable_fast",
             "has_burn", "has_send").index(need)
        if not any(f[j] for f in flags) or all(f[j] for f in flags):
            raise SystemExit(f"kernel_vs_plain: flag {need} not covered "
                             "both ways")
    emit({"phase": "kernel_vs_plain", "configs": len(cases),
          "launches": n_calls, "lanes": n_lanes,
          "flag_combinations": len(flags), "bitwise_equal": True,
          "bitwise_equal_direct_design": True,
          "max_abs_err": max_err,
          "seconds": time.perf_counter() - t0})

    # ---- 4. the main path at full width
    x = np.random.default_rng(42).normal(size=(1, 28, 28)).astype(np.float32)
    net = mnist_net()
    t0 = time.perf_counter()
    plan_tails = fleetsim.build_plan(net, x, "tails", "1mF")
    build_tails = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan_sonic = fleetsim.build_plan(net, x, "sonic", "1mF")
    build_sonic = time.perf_counter() - t0
    runs = (
        ("mnist/tails/adaptive", plan_tails, build_tails, FULL_LANES,
         dict(policy="adaptive", theta=0.5, batch_rows=4, belief_alpha=0.2)),
        ("mnist/sonic/fixed", plan_sonic, build_sonic, FULL_LANES,
         dict(policy="fixed")),
        ("mnist/tails/adaptive/radio-topk-hedge", plan_tails, build_tails,
         RADIO_LANES,
         dict(policy="adaptive", theta=0.5, batch_rows=4, belief_alpha=0.2,
              radio=pack_radio(window, SEND_POLICIES[1]))),
    )
    rec.calls = []
    wrapper.launches = 0                  # zero just before the main path
    for d in wrapper.launches_by_design:
        wrapper.launches_by_design[d] = 0
    results = []
    for label, plan, build_s, lanes, kw in runs:
        before = wrapper.launches
        res = fleetsim.fleet_sweep(plan=plan, n_devices=lanes, seed=42,
                                   charge_cv=0.25, trace_reboots=64,
                                   device="cuda", **kw)
        torch.cuda.synchronize()
        results.append((label, plan, build_s, lanes, kw, res,
                        wrapper.launches - before))
    main_launches = wrapper.launches      # read just after
    main_by_design = dict(wrapper.launches_by_design)
    main_calls = rec.calls
    if main_by_design != {"hoisted": main_launches, "direct": 0}:
        raise SystemExit(f"full_width: the main path launched "
                         f"{main_by_design}, not the hoisted design alone")
    for (label, plan, build_s, lanes, kw, res, delta), call in zip(
            results, main_calls):
        ev0, ev1 = call["events"]
        ms = ev0.elapsed_time(ev1)
        classes_sum = res.classes.sum(-1)
        live = res.energy_j / fleetsim.JOULES_PER_CYCLE
        if delta <= 0:
            raise SystemExit(f"{label}: the kernel did not launch")
        if not np.array_equal(classes_sum, call["out"]["live"].cpu().numpy()):
            raise SystemExit(f"{label}: classes.sum(-1) != live")
        if kw["policy"] == "fixed" and np.any(res.wasted_cycles != 0.0):
            raise SystemExit(f"{label}: wasted != 0 under fixed commits")
        done = res.completed
        if not (np.isfinite(live[done]).all()
                and np.isfinite(res.dead_s[done]).all()):
            raise SystemExit(f"{label}: non-finite channels")
        line = {"phase": "full_width", "run": label, "plan_rows": len(plan),
                "lanes": lanes, "plan_build_s": build_s, "kernel_ms": ms,
                "lanes_per_s": lanes / (ms / 1e3), "launches": delta,
                "completion_rate": float(done.mean()),
                "mean_reboots": float(res.reboots.mean()),
                "classes_sum_equals_live": True}
        if "radio" in kw:
            line["tx_bytes"] = float(res.tx_bytes.sum())
            line["msgs_deferred"] = float(res.msgs_deferred.sum())
        emit(line)
    if main_launches < len(runs):
        raise SystemExit("full_width: fewer launches than runs")

    # each run again on its full-width inputs: the hoisted design against
    # the direct one (bitwise), both timed (median of 5 launches), beside
    # the throughput bound and the chain floor: the rows of the longest
    # lane (each row at least one event) times DEP_F64_OPS_PER_EVENT times
    # the f64 add's dependent latency, measured here in SM cycles and
    # turned into time at the SM clock measured beside it
    lat = cr.f64_latency(torch.device("cuda"))
    emit({"phase": "f64_latency", **lat, "clock": "SM clock (clock64) "
          "over %globaltimer nanoseconds, one thread, 65,536 dependent "
          "adds then as many multiplies"})
    replay_rows = {}
    for (label, plan, build_s, lanes, kw, res, delta), call in zip(
            results, main_calls):
        a, kw_call = call["args"], call["kw"]
        direct = wrapper(*a, **kw_call, design="direct")
        torch.cuda.synchronize()
        ok, err, bad = compare(torch, call["out"], direct)
        if not ok:
            raise SystemExit(f"{label}: the hoisted design != the direct one "
                             f"on {bad}")
        del direct
        ms = median_ms(torch, lambda: wrapper(*a, **kw_call))
        previous = median_ms(torch, lambda: wrapper(*a, **kw_call,
                                                    design="direct"))
        bound_ms, bound_by, bound_info = replay_bound_ms(a, kw_call,
                                                         call["out"], torch)
        rows_max = int(a[7].max())
        chain_floor_ms = rows_max * DEP_F64_OPS_PER_EVENT \
            * lat["add_cycles"] / lat["sm_clock_ghz"] * 1e-6
        row = {"phase": "full_width_timed", "run": label, "lanes": lanes,
               "bitwise_equal_direct_design": True, "ms": ms,
               "previous_ms": previous, "lanes_per_s": lanes / (ms / 1e3),
               "previous_lanes_per_s": lanes / (previous / 1e3),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "chain_floor_ms": chain_floor_ms,
               "chain": f"{rows_max} rows (the longest lane) x "
                        f"{DEP_F64_OPS_PER_EVENT} dependent f64 operations "
                        f"x {lat['add_cycles']:.3f} cycles at "
                        f"{lat['sm_clock_ghz']:.4f} GHz", **bound_info}
        emit(row)
        replay_rows[label] = row

    # kernel against plain on the first run's full-width inputs
    first = main_calls[0]
    a, kw = first["args"], first["kw"]
    t0 = time.perf_counter()
    plain = cr.event_replay(*a, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ok, err, bad = compare(torch, first["out"], plain)
    max_err = max(max_err, err)
    if not ok:
        raise SystemExit(f"full_width: kernel != plain on {bad}")
    headline = replay_rows[results[0][0]]
    emit({"phase": "full_width_vs_plain", "run": results[0][0],
          "lanes": int(a[1].shape[0]), "bitwise_equal": True,
          "kernel_ms": headline["ms"], "plain_ms": plain_ms,
          "bound_ms": headline["bound_ms"], "bound_by": headline["bound_by"]})

    # the first 4 lanes of a full-width har_net tails replay, bitwise
    x_har = np.random.default_rng(7).normal(size=(3, 1, 112)).astype(
        np.float32)
    rec.calls = []
    hoisted_before = wrapper.launches_by_design["hoisted"]
    fleetsim.fleet_sweep(har_net(), x_har, "tails", "1mF",
                         n_devices=HAR_LANES, seed=7, charge_cv=0.25,
                         trace_reboots=64, policy="adaptive", theta=0.5,
                         batch_rows=4, belief_alpha=0.2, device="cuda")
    torch.cuda.synchronize()
    har = rec.calls[0]
    if wrapper.launches_by_design["hoisted"] != hoisted_before + 1:
        raise SystemExit("har: the replay did not launch the hoisted design")
    ok, err, bad = compare(torch, har["out"],
                           wrapper(*har["args"], **har["kw"],
                                   design="direct"))
    if not ok:
        raise SystemExit(f"har: the hoisted design != the direct one on "
                         f"{bad}")
    a4, kw4 = lane_slice(har["args"], har["kw"], 4,
                         har["kw"]["shared_rows"])
    t0 = time.perf_counter()
    plain4 = cr.event_replay(*a4, **kw4)
    torch.cuda.synchronize()
    har_plain_ms = (time.perf_counter() - t0) * 1e3
    full4 = {k: v[:4] for k, v in har["out"].items()}
    ok, err, bad = compare(torch, full4, plain4)
    max_err = max(max_err, err)
    if not ok:
        raise SystemExit(f"har: kernel != plain on {bad}")
    emit({"phase": "har_first_lanes", "plan_rows": int(a4[7].max()),
          "lanes": HAR_LANES, "checked_lanes": 4, "bitwise_equal": True,
          "bitwise_equal_direct_design": HAR_LANES,
          "plain_ms": har_plain_ms})

    # ---- 5b. the PlanSet design sweep; 5c. the streamed statistics
    design_line = design_sweep(torch, np, emit, fleetsim, cr, rec, wrapper,
                               net, x, plan_tails, plan_sonic)
    fold_entry = streamed_stats(torch, np, emit, fleetsim, cr, rec, wrapper,
                                net, x, plan_tails, lat)
    cr.charge_replay = wrapper
    # ---- 5c'. the closed form's kernel beside the aten graph it replaced
    closed_lines = closed_form_phase(torch, np, emit, fleetsim, plan_tails)
    # ---- 5d. the overlapped pipeline under the JAX package's protocol
    overlap(torch, np, emit, fleetsim, classes)
    # ---- 5e. GENESIS end to end: the sweep's pricing folds on the card
    genesis_line = genesis(torch, np, emit, fleetsim, cr, wrapper,
                           defer=True)
    fold_entry["launches"] += genesis_line["stats_fold_launches"]
    # ---- 5f. the legacy _while oracle against the lane kernel
    t0 = time.perf_counter()
    while_line = while_oracle(torch, np, emit, fleetsim, wrapper, classes)
    emit({"phase": "while_oracle", **while_line,
          "seconds": time.perf_counter() - t0})
    # ---- 5g. mesh= on the card: each shard's lane kernel and fold
    t0 = time.perf_counter()
    mesh_launches = mesh(torch, np, emit, fleetsim, wrapper, net, x,
                         plan_tails)
    emit({"phase": "mesh", "launches": mesh_launches,
          "seconds": time.perf_counter() - t0})
    fold_entry["launches"] += mesh_launches["stats_fold"]
    fold_entry["mesh_launches"] = mesh_launches["stats_fold"]
    # ---- 5h. the paper's end-to-end demonstration (its own process), the
    # Fig. 9 matrix and the design space on the card against the CPU
    paper = paper_demo(torch, np, emit, fleetsim, smi_line,
                       reference=paper_reference)
    # GENESIS's pricing and closed-form scan against the CPU's (its worker
    # ran beside the phases since)
    genesis_cpu_check(torch, np, emit, genesis_line["cpu_reference"])
    paper_lane = {k.split("/")[1]: v for k, v in paper["launches"].items()
                  if k.startswith("charge_replay/")}
    fold_entry["launches"] += paper["launches"]["stats_fold"]
    fold_entry["paper_demo_launches"] = paper["launches"]["stats_fold"]
    closed_entry = closed_form_entry(closed_lines, {
        "closed_form": sum(ln["launches"] for ln in closed_lines),
        "genesis": genesis_line["closed_form_launches"],
        "paper_demo": paper["closed_form_launches"]})

    # ---- 6, 7. the compute kernels: against their plain versions, then at
    # full width with their launches counted
    compute = compute_kernels(torch, np, emit, hopper)

    # ---- 8, 9. the LM slice: attention and SSD kernels against their plain
    # versions, then the qwen3-0.6b forward at full width
    lm = lm_kernels(torch, np, emit, hopper)
    # ---- 10. serving: prefill, KV-cache decode and the engine on
    # qwen3-0.6b, then mamba2-370m's forward through ssd_intra, its decode
    # and its engine; their launches join the kernels line's
    served = serving(torch, np, emit, smi_line)
    for entry in lm:
        n = served[entry["name"]]
        entry["launches"] += n
        entry["serving_launches"] = n
        entry["serving_launches_by_path"] = served[entry["name"]
                                                   + "_by_path"]
    # ---- 11-13. the MoE block (qwen3-moe, llama4-scout), the vlm family
    # (internvl2), then training through the kernels' autograd wrappers;
    # their launches join the kernels line's
    launched = {"moe": moe_phase(torch, np, emit, smi_line),
                "vlm": vlm_phase(torch, np, emit, smi_line),
                "train": train_phase(torch, np, emit, smi_line)}
    # ---- 14-15. the hybrid family (zamba2-7b) and the encdec family
    # (whisper-small); their launches join the kernels line's, by path
    launched["hybrid"] = hybrid_phase(torch, np, emit, smi_line)
    launched["encdec"] = encdec_phase(torch, np, emit, smi_line)
    # ---- 16. the sharded LM launch path: train(mesh=...) against the
    # unmeshed trainer, a dry-run record and the LM examples
    launched["lm_mesh"] = lm_mesh_phase(torch, np, emit, smi_line)
    for entry in lm:
        for phase, counts in launched.items():
            n = counts.get(entry["name"], 0)
            entry["launches"] += n
            entry[f"{phase}_launches"] = n
            by_path = counts.get(entry["name"] + "_by_path")
            if by_path is not None:
                entry[f"{phase}_launches_by_path"] = by_path
            shape = counts.get("shapes", {}).get(entry["name"])
            if shape is not None:
                entry[f"{phase}_shape"] = {
                    k: shape[k] for k in ("shape", "path", "ms",
                                          "previous_ms", "plain_ms",
                                          "library_ms", "bound_ms",
                                          "bound_by", "max_abs_err")
                    if k in shape}

    # ---- 17. the kernels line, the card, the result
    emit({"kernels": [{
        "name": "charge_replay", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/charge_replay.cu",
        "replaces": "src/repro/kernels/charge_replay.py:907",
        "replaces_function": "pallas_replay",
        "launches": main_launches + mesh_launches["charge_replay"]
        + sum(paper_lane.values()),
        "mesh_launches": mesh_launches["charge_replay"],
        "paper_demo_launches_by_mode": paper_lane,
        "max_abs_err": max_err,
        "max_abs_diff_vs_plain": max_err,
        "ms": headline["ms"], "previous_ms": headline["previous_ms"],
        "plain_ms": plain_ms, "bound_ms": headline["bound_ms"],
        "bound_by": headline["bound_by"],
        "chain_floor_ms": headline["chain_floor_ms"], "library_ms": None,
        "design": "hoisted", "previous_design": "direct",
        "plan_mode_launches": design_line["launches"],
        "genesis_plan_mode_launches": genesis_line["lane_kernel_launches"],
        "plan_mode_ms": design_line["kernel_ms"],
        "plan_mode_solo_ms_sum": design_line["solo_ms_sum"],
        "plan_mode_shape": f"{len(design_line['candidates'])} candidates "
                           f"x {design_line['devices_per_candidate']} "
                           f"lanes, table {design_line['table_shape']}",
        "shape": f"{results[0][0]}: {len(results[0][1])} rows x "
                 f"{int(a[1].shape[0])} lanes"}, fold_entry, closed_entry]
        + compute + lm})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_workers()

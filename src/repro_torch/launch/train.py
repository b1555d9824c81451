"""End-to-end trainer with intermittence-safe progress, on one card or the
CPU: the counterpart of the JAX package's ``repro.launch.train``.

The training loop is written exactly like a SONIC loop nest:

  * the *step cursor* and *data position* live in a durable Cursor file,
    committed atomically after every step (loop continuation);
  * full (params, opt) checkpoints go to A/B slots with an atomic manifest
    flip every ``ckpt_interval`` steps (loop-ordered buffering);
  * steps are idempotent: data is addressed by step index, so re-executing
    an interrupted step reproduces identical state (bit-exact:
    ``tests/test_torch_lm_train.py``, ``tests/test_torch_mesh_train.py``,
    and on the card ``chip_smoke.py``'s ``train`` and ``lm_mesh``
    phases).

A step is eager PyTorch: ``loss_fn`` forward, autograd backward (the
attention and SSD kernels under their ``torch.autograd.Function``s on the
card), then ``optim.adamw``'s update.  ``mesh=None`` trains on one device,
unmeshed.  On an :class:`~repro_torch.launch.mesh.LMMesh` one process
drives every shard (no ``torch.distributed`` process group):

  * parameters live as the blocks ``launch.shardings.tree_specs`` gives,
    the AdamW moments as its ZeRO-1 blocks (``zero1=True``);
  * the batch splits over the data shards (``shardings.batch_spec``); each
    shard's loss and gradient are computed on its device with the weights
    gathered whole, and the shard gradients are summed in shard order and
    divided by their count;
  * the trainer's own AdamW update (its global-norm clip included) runs
    once on the whole leaves, gathered onto the first data shard's
    device, and its results are placed back as blocks by the same specs.
    So with one data shard a meshed step gives the unmeshed step's bits,
    and on a (1, 1) mesh the gather and the placement copy nothing;
  * checkpoints hold whole, gathered leaves, so meshed and unmeshed runs
    write the same files and resume from each other's.

Usage (CPU example scale; drop ``--device cpu`` to train on the card):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --steps 50 --batch 8 --seq 64 --device cpu
"""

from __future__ import annotations

import argparse
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..checkpoint import Cursor, SlotStore
from ..configs import ARCHS, get_config
from ..data import token_batches
from ..device import resolve_device
from ..models import get_model
from ..optim import adamw, cosine_schedule
from ..optim.adamw import _map
from . import shardings
from .mesh import LMMesh


class SimulatedFailure(Exception):
    """Raised by the failure injector (tests / chaos drills)."""


@dataclass
class TrainResult:
    steps_run: int
    final_step: int
    losses: list
    wall_s: float


def _batch(arrays: dict, device) -> dict:
    """A numpy batch as integer tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device).long()
            for k, v in arrays.items()}


def make_grad_fn(cfg, api):
    """``grad_fn(params, batch) -> (loss, grads)``: the loss (a detached
    scalar tensor) and its gradient, a tree shaped as ``params``, each
    leaf in its parameter's dtype; a leaf the loss does not reach (an
    empty ``mamba_tail`` of a hybrid model) gets zeros, as ``jax.grad``
    gives it."""
    def grad_fn(params, batch):
        leaves = _map(lambda p: p.detach().requires_grad_(True), params)
        loss = api.loss_fn(cfg, leaves, batch)
        loss.backward()
        return loss.detach(), _map(
            lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
            leaves)
    return grad_fn


def make_train_step(cfg, api, opt):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``."""
    grad_fn = make_grad_fn(cfg, api)

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss
    return train_step


def _init_state(cfg, api, opt, seed: int, device):
    params = api.init_params(cfg, seed=seed, device=device)
    return params, opt.init(params)


def data_shard_devices(mesh: LMMesh, global_batch: int) -> list:
    """The devices of the data shards in shard order: the batch axes of
    ``shardings.batch_spec`` in row-major order, every other axis at 0."""
    axes = shardings.batch_spec(mesh, global_batch)
    out = []
    for pos in np.ndindex(*(mesh.shape[a] for a in axes)):
        where = dict(zip(axes, pos))
        out.append(mesh.devices[tuple(where.get(a, 0)
                                      for a in mesh.axis_names)])
    return out


def make_sharded_train_step(cfg, api, opt, mesh: LMMesh):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)`` on ``mesh``: ``params`` and ``opt_state`` are trees of
    :class:`~repro_torch.launch.shardings.Sharded` leaves, ``batch`` the
    step's whole numpy arrays.  The order of the arithmetic is the module
    docstring's."""
    grad_fn = make_grad_fn(cfg, api)

    def train_step(params, opt_state, batch):
        rows = len(next(iter(batch.values())))
        devices = data_shard_devices(mesh, rows)
        n = len(devices)
        rows //= n
        home = devices[0]
        losses, grads = [], None
        for i, dev in enumerate(devices):
            loss, g = grad_fn(shardings.gather_tree(params, dev),
                              _batch({k: v[i * rows:(i + 1) * rows]
                                      for k, v in batch.items()}, dev))
            losses.append(loss.to(home))
            grads = g if grads is None else _map(
                lambda a, b: a + b.to(home), grads, g)
        if n > 1:
            grads = _map(lambda a: a / n, grads)
            loss = sum(losses[1:], losses[0]) / n
        else:
            loss = losses[0]
        params, opt_state = update_sharded(opt, grads, opt_state, params)
        return params, opt_state, loss
    return train_step


def update_sharded(opt, grads, opt_state, params) -> tuple:
    """``opt.update`` (which clips by the global norm) of the whole
    gathered ``params`` and ``opt_state`` from the whole ``grads``, on the
    devices ``grads`` lie on, each result placed back by its leaf's spec:
    the :class:`~repro_torch.launch.shardings.Sharded` ``(params,
    opt_state)``.  On a one-device mesh nothing is copied."""
    home = shardings.tree_leaves(grads)[0].device
    specs = [shardings.tree_map(lambda x: x.spec, t)
             for t in (params, opt_state)]
    new = opt.update(grads, shardings.gather_tree(opt_state, home),
                     shardings.gather_tree(params, home))
    mesh = shardings.tree_leaves(params)[0].mesh
    return tuple(shardings.shard_tree(t, sp, mesh)
                 for t, sp in zip(new, specs))


def train(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: str,
          ckpt_interval: int = 20, lr: float = 3e-4, seed: int = 0,
          mesh=None, fail_at_step: int | None = None,
          log_every: int = 10, device="cuda") -> TrainResult:
    """Train ``cfg`` from ``seed`` for ``steps`` steps of ``batch`` x
    ``seq`` synthetic tokens (``data.token_batches``), checkpointing to
    ``ckpt_dir`` every ``ckpt_interval`` steps and at the end; a run that
    finds a committed checkpoint there resumes from it.
    ``fail_at_step`` raises :class:`SimulatedFailure` just before that
    step.

    ``mesh=None`` trains unmeshed on ``device``: on a host with one card
    that computes what the JAX package's default mesh,
    ``make_host_mesh((jax.device_count(), 1))``, computes.  An
    :class:`~repro_torch.launch.mesh.LMMesh` (``make_host_mesh``) trains
    sharded on its devices as the module docstring says; ``device`` is
    then not read."""
    if mesh is None:
        dev = resolve_device(device)
    elif not isinstance(mesh, LMMesh) or mesh.devices is None:
        raise ValueError(f"mesh must be an LMMesh over devices "
                         f"(launch.mesh.make_host_mesh), got {mesh!r}")
    else:
        dev = mesh.devices.flat[0]
    api = get_model(cfg)
    lr_fn = cosine_schedule(lr, warmup=max(steps // 20, 1), total=steps)
    opt = adamw(lr=lr_fn)
    store = SlotStore(Path(ckpt_dir) / "state")
    cursor = Cursor(Path(ckpt_dir) / "cursor.json")

    # ---- restore or init (loop continuation: never restart from scratch)
    params, opt_state = _init_state(cfg, api, opt, seed, dev)
    state, meta = store.restore(like=[params, opt_state])
    if state is not None and meta and meta.get("step") is not None:
        # resume: restore the A/B front slot and replay deterministically
        # from its step (the step cursor ahead of it is observability only;
        # restartable progress is bounded by the durable state)
        start_step = int(meta["step"])
        params, opt_state = state
    else:
        start_step = 0
    del state
    if mesh is None:
        step_fn = make_train_step(cfg, api, opt)
    else:
        params = shardings.shard_tree(
            params, shardings.tree_specs(params, mesh), mesh)
        opt_state = shardings.shard_tree(
            opt_state, shardings.tree_specs(opt_state, mesh, zero1=True),
            mesh)
        step_fn = make_sharded_train_step(cfg, api, opt, mesh)

    losses = []
    t0 = time.time()
    steps_run = 0
    data = token_batches(cfg.vocab_size, batch, seq, steps, seed=seed)
    for step, batch_np in enumerate(data):
        if step < start_step:         # data stream is addressed by step
            continue
        if fail_at_step is not None and step == fail_at_step:
            raise SimulatedFailure(f"injected failure at step {step}")
        params, opt_state, loss = step_fn(
            params, opt_state,
            _batch(batch_np, dev) if mesh is None else batch_np)
        losses.append(float(loss))
        steps_run += 1
        # loop-continuation commit: O(bytes of cursor), every step
        cursor.commit(step=step + 1, data_seed=seed)
        if (step + 1) % ckpt_interval == 0 or step + 1 == steps:
            # whole leaves, as jax.device_get gives them
            store.save(shardings.gather_tree([params, opt_state]),
                       meta={"step": step + 1, "cfg": cfg.name})
            cursor.commit(step=step + 1, checkpointed=step + 1)
        if log_every and (step + 1) % log_every == 0:
            print(f"step {step+1}/{steps} loss={float(loss):.4f}",
                  flush=True)
    return TrainResult(steps_run, start_step + steps_run, losses,
                       time.time() - t0)


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a new temporary directory")
    ap.add_argument("--ckpt-interval", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.scaled_down()
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_train_")
    res = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                ckpt_dir=ckpt_dir, ckpt_interval=args.ckpt_interval,
                lr=args.lr, device=args.device)
    print(f"ran {res.steps_run} steps to step {res.final_step}; "
          f"loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f} "
          f"in {res.wall_s:.1f}s")
    return res


# --------------------------------------------------------------------------
# Microbatch-level loop continuation (the paper's in-loop cursor, for real)
# --------------------------------------------------------------------------

def train_microbatched(cfg, *, steps: int, batch: int, seq: int,
                       microbatches: int, ckpt_dir: str, lr: float = 3e-4,
                       seed: int = 0, fail_at: tuple | None = None,
                       log_every: int = 0, device="cuda") -> TrainResult:
    """Gradient-accumulation trainer whose progress cursor is the
    (step, microbatch) pair -- the exact fleet analogue of SONIC's loop
    continuation:

      * (params, opt) checkpoint to A/B slots at every step boundary
        (loop-ordered buffering: the committed front slot is never torn);
      * the f32 gradient accumulator + microbatch cursor commit durably
        after EVERY microbatch, so a mid-step failure re-executes at most
        one microbatch (vs the whole step -- or the whole interval -- for
        checkpoint-only recovery);
      * microbatches are idempotent: data is addressed by (step, mb), so
        re-execution is bit-exact (``tests/test_torch_lm_train.py``).

    ``fail_at=(step, mb)`` injects a failure just before that microbatch.
    """
    if batch % microbatches:
        raise ValueError(f"batch {batch} is not a multiple of "
                         f"{microbatches} microbatches")
    mb_size = batch // microbatches
    dev = resolve_device(device)
    api = get_model(cfg)
    opt = adamw(lr=lr)
    state_store = SlotStore(Path(ckpt_dir) / "state")
    accum_store = SlotStore(Path(ckpt_dir) / "accum")
    cursor = Cursor(Path(ckpt_dir) / "cursor.json")
    grad_fn = make_grad_fn(cfg, api)

    def zeros(tree):
        return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)

    # ---- restore --------------------------------------------------------
    params, opt_state = _init_state(cfg, api, opt, seed, dev)
    state, meta = state_store.restore(like=[params, opt_state])
    if state is not None and meta:
        start_step = int(meta["step"])
        params, opt_state = state
    else:
        start_step = 0
    del state

    cur = cursor.read()
    start_mb = 0
    accum = zeros(params)
    if (cur.get("step") == start_step and cur.get("mb", 0) > 0):
        saved, ameta = accum_store.restore(like=accum)
        if saved is not None and ameta and \
                ameta.get("step") == start_step and \
                ameta.get("mb") == cur["mb"]:
            start_mb = int(cur["mb"])      # resume mid-step
            accum = saved

    losses = []
    t0 = time.time()
    steps_run = 0
    for step in range(start_step, steps):
        rs = np.random.default_rng(seed + 104729 * step)
        step_tokens = rs.choice(cfg.vocab_size, size=(batch, seq)
                                ).astype(np.int32)
        step_tokens[:, 1::2] = step_tokens[:, 0:-1:2]
        mb0 = start_mb if step == start_step else 0
        if mb0 == 0:
            accum = zeros(params)
        for mb in range(mb0, microbatches):
            if fail_at is not None and (step, mb) == tuple(fail_at):
                raise SimulatedFailure(f"injected at step {step} mb {mb}")
            sl = slice(mb * mb_size, (mb + 1) * mb_size)
            bj = _batch({"tokens": step_tokens[sl],
                         "labels": step_tokens[sl]}, dev)
            loss, grads = grad_fn(params, bj)
            accum = _map(lambda a, g: a + g.to(torch.float32), accum, grads)
            # SONIC commit: durable accumulator (A/B slots) + cursor word
            accum_store.save(accum, meta={"step": step, "mb": mb + 1})
            cursor.commit(step=step, mb=mb + 1)
            losses.append(float(loss))
        mean_grads = _map(lambda a: a / microbatches, accum)
        params, opt_state = opt.update(mean_grads, opt_state, params)
        steps_run += 1
        state_store.save([params, opt_state], meta={"step": step + 1})
        cursor.commit(step=step + 1, mb=0)
        if log_every and (step + 1) % log_every == 0:
            print(f"step {step+1}/{steps} loss={losses[-1]:.4f}", flush=True)
    return TrainResult(steps_run, steps, losses, time.time() - t0)


if __name__ == "__main__":
    main()

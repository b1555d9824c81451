"""End-to-end trainer with intermittence-safe progress, on one card or the
CPU: the counterpart of the JAX package's ``repro.launch.train``.

The training loop is written exactly like a SONIC loop nest:

  * the *step cursor* and *data position* live in a durable Cursor file,
    committed atomically after every step (loop continuation);
  * full (params, opt) checkpoints go to A/B slots with an atomic manifest
    flip every ``ckpt_interval`` steps (loop-ordered buffering);
  * steps are idempotent: data is addressed by step index, so re-executing
    an interrupted step reproduces identical state (bit-exact on one
    device: ``tests/test_torch_lm_train.py``, and on the card
    ``chip_smoke.py``'s ``train`` phase).

A step is eager PyTorch: ``loss_fn`` forward, autograd backward (the
attention and SSD kernels under their ``torch.autograd.Function``s on the
card), then ``optim.adamw``'s update.  The JAX package shards the step
over a device mesh; here ``mesh`` must be None (one device) until
``launch/shardings.py`` is ported.

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

#: Where the sharded trainer waits in ``ROADMAP.md``.
MESH_ITEM = "ROADMAP.md Queue 1 item 18 (launch/)"


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


def train(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: str,
          ckpt_interval: int = 20, lr: float = 3e-4, seed: int = 0,
          mesh=None, fail_at_step: int | None = None,
          log_every: int = 10, device="cuda") -> TrainResult:
    """Train ``cfg`` from ``seed`` for ``steps`` steps of ``batch`` x
    ``seq`` synthetic tokens (``data.token_batches``), checkpointing to
    ``ckpt_dir`` every ``ckpt_interval`` steps and at the end; a run that
    finds a committed checkpoint there resumes from it.
    ``fail_at_step`` raises :class:`SimulatedFailure` just before that
    step."""
    if mesh is not None:
        raise NotImplementedError(f"a sharded trainer (mesh={mesh!r}) needs "
                                  f"launch/shardings.py, not ported yet: "
                                  f"{MESH_ITEM}")
    dev = resolve_device(device)
    api = get_model(cfg)
    opt = adamw(lr=cosine_schedule(lr, warmup=max(steps // 20, 1),
                                   total=steps))
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
    step_fn = make_train_step(cfg, api, opt)

    losses = []
    t0 = time.time()
    steps_run = 0
    data = token_batches(cfg.vocab_size, batch, seq, steps, seed=seed)
    for step, batch_np in enumerate(data):
        if step < start_step:         # data stream is addressed by step
            continue
        if fail_at_step is not None and step == fail_at_step:
            raise SimulatedFailure(f"injected failure at step {step}")
        params, opt_state, loss = step_fn(params, opt_state,
                                          _batch(batch_np, dev))
        losses.append(float(loss))
        steps_run += 1
        # loop-continuation commit: O(bytes of cursor), every step
        cursor.commit(step=step + 1, data_seed=seed)
        if (step + 1) % ckpt_interval == 0 or step + 1 == steps:
            store.save([params, opt_state],
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

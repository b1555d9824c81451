"""The port's trainer (``repro_torch.launch.train``) on the CPU: two steps
of ``make_train_step`` against the JAX package's from the same carried
parameters, and the resumable loops' bit-exact resume (the cases of
``tests/test_train_resume.py``), also on bf16 parameters, which every
published config has.

Weights are made by the JAX package from a seed and carried across with
``repro_torch.convert.lm_params_from_numpy``; the batches are the
trainer's own (``data.token_batches``).  Tolerances: losses rtol 1e-5
(f32 sums in another order); parameters after two AdamW steps atol
1e-2 x lr, where the element's gradient is above f32 noise (see
``test_two_train_steps_match_jax``).  Resume is bitwise, as the JAX
package's own claim is.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import train as jtrain
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import Cursor, SlotStore
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, model_config_from_fields
from repro_torch.data import token_batches
from repro_torch.launch import train
from repro_torch.launch.train import (SimulatedFailure, TrainResult,
                                      make_train_step, train_microbatched)
from repro_torch.models import get_model
from repro_torch.optim import adamw
from repro_torch.optim.adamw import _leaves

LR = 1e-3
CFG = get_config("qwen3-0.6b").scaled_down(num_layers=1, d_model=32,
                                           vocab_size=128, d_ff=64)


# --------------------------------------------------------------------------
# Two steps against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-moe-30b-a3b",
                                  "mamba2-370m", "zamba2-7b"])
def test_two_train_steps_match_jax(arch):
    """Two AdamW steps from the same carried parameters on the same two
    batches: each step's loss, then every parameter.  AdamW divides each
    element's moment by the root of its second moment, so an element whose
    gradient is at f32 noise of zero (nonzero but below 1e-4 of its leaf's
    largest, where the two packages' sums in another order differ by some
    per cent of it) takes a step whose size is that noise's; such elements
    are held within 2 lr (an AdamW step with b1 = 0.9, b2 = 0.95 moves an
    element by at most lr in its first two steps, weight decay aside,
    which both packages apply alike), the rest within 1e-2 lr.
    zamba2-7b scaled down has two super-blocks and no trailing block: its
    empty ``mamba_tail`` leaves take zero gradients, as ``jax.grad``
    gives them."""
    jcfg = jax_config(arch).scaled_down()
    jparams = japi.get_model(jcfg).init_params(jcfg, jax.random.key(0))
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    jopt, opt = jadamw(lr=LR), adamw(lr=LR)
    japi_ = japi.get_model(jcfg)
    jstep = jax.jit(jtrain.make_train_step(jcfg, japi_, jopt))
    jgrad = jax.jit(jtrain.make_grad_fn(jcfg, japi_))
    step = make_train_step(cfg, get_model(cfg), opt)
    jstate, state = jopt.init(jparams), opt.init(params)
    sharp = [np.ones(np.shape(a), bool) for a in jax.tree.leaves(jparams)]
    for batch in token_batches(cfg.vocab_size, 2, 32, 2, seed=3):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        _, grads = jgrad(jparams, jb)
        for m, g in zip(sharp, jax.tree.leaves(grads)):
            g = np.abs(np.asarray(g))
            m &= (g == 0) | (g >= 1e-4 * g.max(initial=0))
        jparams, jstate, jloss = jstep(jparams, jstate, jb)
        params, state, loss = step(
            params, state, {k: torch.tensor(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(state.step) == int(jstate.step) == 2
    for got, want, m in zip(_leaves(params), jax.tree.leaves(jparams),
                            sharp):
        d = np.abs(got.numpy() - np.asarray(want))
        assert d[m].max(initial=0) <= 1e-2 * LR
        assert d.max(initial=0) <= 2 * LR


# --------------------------------------------------------------------------
# Resumable loops (tests/test_train_resume.py's cases)
# --------------------------------------------------------------------------

def run(ckpt_dir, steps=12, fail_at=None):
    return train.train(CFG, steps=steps, batch=2, seq=16,
                       ckpt_dir=str(ckpt_dir), ckpt_interval=4, seed=0,
                       fail_at_step=fail_at, log_every=0, device="cpu")


def final_params(ckpt_dir):
    return SlotStore(ckpt_dir / "state").restore()


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_resume_is_bit_exact(tmp_path):
    run(tmp_path / "ref", steps=12)
    ref_leaves, ref_meta = final_params(tmp_path / "ref")
    assert ref_meta["step"] == 12

    # interrupted at step 6 (mid checkpoint interval), then resumed
    with pytest.raises(SimulatedFailure):
        run(tmp_path / "int", steps=12, fail_at=6)
    res = run(tmp_path / "int", steps=12)
    # resume replays deterministically from the last checkpoint (step 4)
    assert res.steps_run == 8 and res.final_step == 12
    int_leaves, int_meta = final_params(tmp_path / "int")
    assert int_meta["step"] == 12
    _same(ref_leaves, int_leaves)


def test_loss_decreases(tmp_path):
    res = train.train(CFG, steps=40, batch=4, seq=16,
                      ckpt_dir=str(tmp_path / "t"), ckpt_interval=20,
                      lr=2e-3, seed=0, log_every=0, device="cpu")
    head = np.mean(res.losses[:5])
    tail = np.mean(res.losses[-5:])
    assert tail < head, f"training must make progress ({head}->{tail})"


def test_double_failure_still_converges(tmp_path):
    with pytest.raises(SimulatedFailure):
        run(tmp_path / "d", steps=12, fail_at=3)
    with pytest.raises(SimulatedFailure):
        run(tmp_path / "d", steps=12, fail_at=9)
    run(tmp_path / "d", steps=12)
    leaves, meta = final_params(tmp_path / "d")
    assert meta["step"] == 12
    run(tmp_path / "ref2", steps=12)
    _same(final_params(tmp_path / "ref2")[0], leaves)


def test_microbatch_resume_bit_exact(tmp_path):
    """Kill the trainer INSIDE a step (between microbatches); the resumed
    run restores the durable gradient accumulator and re-executes only the
    remaining microbatches -- final params bit-identical to
    uninterrupted."""
    kw = dict(steps=4, batch=8, seq=16, microbatches=4, seed=0,
              device="cpu")
    train_microbatched(CFG, ckpt_dir=str(tmp_path / "ref"), **kw)
    ref_leaves, ref_meta = final_params(tmp_path / "ref")
    assert ref_meta["step"] == 4

    with pytest.raises(SimulatedFailure):
        train_microbatched(CFG, ckpt_dir=str(tmp_path / "mid"),
                           fail_at=(2, 2), **kw)
    cur = Cursor(tmp_path / "mid" / "cursor.json").read()
    assert (cur["step"], cur["mb"]) == (2, 2)
    res = train_microbatched(CFG, ckpt_dir=str(tmp_path / "mid"), **kw)
    assert res.steps_run == 2 and len(res.losses) == 2 + 4
    mid_leaves, mid_meta = final_params(tmp_path / "mid")
    assert mid_meta["step"] == 4
    _same(ref_leaves, mid_leaves)


def test_microbatch_trainer_runs_as_jax_s(tmp_path):
    """Both packages' microbatched trainers on the same config and data:
    the same steps, loss count and final cursor record (each starts from
    its own package's init, so the losses themselves differ)."""
    kw = dict(steps=2, batch=4, seq=16, microbatches=2, seed=0)
    jres = jtrain.train_microbatched(
        jax_config("qwen3-0.6b").scaled_down(num_layers=1, d_model=32,
                                             vocab_size=128, d_ff=64),
        ckpt_dir=str(tmp_path / "jax"), **kw)
    res = train_microbatched(CFG, ckpt_dir=str(tmp_path / "port"),
                             device="cpu", **kw)
    assert isinstance(res, TrainResult)
    assert (res.steps_run, res.final_step, len(res.losses)) == \
        (jres.steps_run, jres.final_step, len(jres.losses))
    assert Cursor(tmp_path / "port" / "cursor.json").read() == \
        Cursor(tmp_path / "jax" / "cursor.json").read()


def test_microbatches_must_divide_the_batch(tmp_path):
    with pytest.raises(ValueError, match="microbatches"):
        train_microbatched(CFG, steps=1, batch=6, seq=8, microbatches=4,
                           ckpt_dir=str(tmp_path), device="cpu")


def test_train_launcher_on_cpu(tmp_path, capsys):
    res = train.main(["--smoke", "--device", "cpu", "--steps", "3",
                      "--batch", "2", "--seq", "16", "--ckpt-dir",
                      str(tmp_path), "--ckpt-interval", "2"])
    assert (res.steps_run, res.final_step, len(res.losses)) == (3, 3, 3)
    assert "ran 3 steps to step 3" in capsys.readouterr().out
    assert SlotStore(tmp_path / "state").manifest()["meta"]["step"] == 3


def test_bf16_training_state_resumes_bit_exact(tmp_path):
    """bf16 parameters (the published dtypes) through a checkpoint: the
    resumed run ends on the uninterrupted run's bits."""
    cfg = dataclasses.replace(CFG, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    kw = dict(steps=6, batch=2, seq=16, ckpt_interval=2, seed=0,
              log_every=0, device="cpu")
    train.train(cfg, ckpt_dir=str(tmp_path / "ref"), **kw)
    with pytest.raises(SimulatedFailure):
        train.train(cfg, ckpt_dir=str(tmp_path / "int"), fail_at_step=3,
                    **kw)
    train.train(cfg, ckpt_dir=str(tmp_path / "int"), **kw)
    ref, _ = final_params(tmp_path / "ref")
    got, _ = final_params(tmp_path / "int")
    assert ref[0].dtype == torch.bfloat16
    for a, b in zip(ref, got):
        if torch.is_tensor(a):
            assert a.dtype == b.dtype and torch.equal(a.view(torch.int16),
                                                      b.view(torch.int16))
        else:
            np.testing.assert_array_equal(a, b)

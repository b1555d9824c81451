"""The sharded trainer, ``repro_torch.launch.train.train(mesh=...)``, on
CPU meshes (``launch.mesh.make_host_mesh(..., device="cpu")``).

One data shard ((1, 1), (1, 2)) is bitwise the unmeshed trainer: every
loss and the checkpoint files' bytes (every parameter and moment).  Two
data shards ((2, 1), (2, 2)) sum the shards' gradients in another order,
so they are held to ``tests/test_torch_lm_train.py``'s tolerances: losses
rtol 1e-5, parameters atol 1e-2 x lr where the element's gradient is
above f32 noise (1e-4 of its leaf's largest; AdamW turns a gradient at
noise into a step of noise's size, held within 2 lr like the rest).  The
placement is exact: each block has the shape its spec gives and each
device holds ``sharded_bytes``.  A failure and resume on a (2, 2) mesh
ends on an uninterrupted (2, 2) run's bits, meshed and unmeshed runs
resume from each other's files, and (1, 1) matches the JAX package's
``train`` at those tolerances.
"""

import dataclasses
import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import train as jtrain
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.optim import cosine_schedule as jcosine
from repro_torch.checkpoint import SlotStore
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, model_config_from_fields
from repro_torch.data import token_batches
from repro_torch.launch import shardings
from repro_torch.launch import train as trainer
from repro_torch.launch.mesh import (make_fleet_mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.train import SimulatedFailure
from repro_torch.models import get_model
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.optim.adamw import _leaves

LR = 1e-3
CFG = get_config("qwen3-0.6b").scaled_down(num_layers=1, d_model=32,
                                           vocab_size=128, d_ff=64)
KW = dict(steps=4, batch=4, seq=16, ckpt_interval=2, lr=LR, seed=0,
          log_every=0, device="cpu")


def run(tmp, name, mesh_shape=None, **kw):
    mesh = None if mesh_shape is None else make_host_mesh(mesh_shape,
                                                          device="cpu")
    return trainer.train(CFG, ckpt_dir=str(tmp / name), mesh=mesh,
                         **(KW | kw))


def front(tmp, name):
    store = SlotStore(tmp / name / "state")
    m = store.manifest()
    return store.root / m["slot"], m


def same_files(tmp, a, b) -> bool:
    (da, ma), (db, mb) = front(tmp, a), front(tmp, b)
    assert ma["leaves"] == mb["leaves"] and ma["meta"] == mb["meta"]
    return all(filecmp.cmp(da / n, db / n, shallow=False)
               for n in ma["leaves"])


def restored(tmp, name):
    leaves, meta = SlotStore(tmp / name / "state").restore()
    return leaves, meta


@pytest.fixture(scope="module")
def unmeshed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("unmeshed")
    return tmp, run(tmp, "u")


@pytest.mark.parametrize("shape", [(1, 1), (1, 2)])
def test_one_data_shard_is_bitwise_the_unmeshed_trainer(unmeshed, tmp_path,
                                                        shape):
    tmp_u, res_u = unmeshed
    res = run(tmp_path, "m", shape)
    assert res.losses == res_u.losses
    assert (res.steps_run, res.final_step) == (res_u.steps_run,
                                               res_u.final_step)
    (da, ma), (db, mb) = front(tmp_u, "u"), front(tmp_path, "m")
    assert ma["leaves"] == mb["leaves"] and ma["meta"] == mb["meta"]
    for n in ma["leaves"]:
        assert filecmp.cmp(da / n, db / n, shallow=False), n


def _sharp_masks(steps: int):
    """Per parameter leaf, the elements whose gradient is above f32 noise
    (or zero) at every step of the unmeshed run."""
    api = get_model(CFG)
    opt = adamw(lr=cosine_schedule(LR, warmup=max(steps // 20, 1),
                                   total=steps))
    params = api.init_params(CFG, seed=0, device="cpu")
    state = opt.init(params)
    grad_fn = trainer.make_grad_fn(CFG, api)
    step = trainer.make_train_step(CFG, api, opt)
    sharp = None
    for batch in token_batches(CFG.vocab_size, KW["batch"], KW["seq"],
                               steps, seed=0):
        b = trainer._batch(batch, "cpu")
        _, grads = grad_fn(params, b)
        masks = [(g == 0) | (g.abs() >= 1e-4 * g.abs().max())
                 for g in _leaves(grads)]
        sharp = masks if sharp is None else [a & m for a, m in
                                             zip(sharp, masks)]
        params, state, _ = step(params, state, b)
    return sharp


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_two_data_shards_within_the_train_tolerances(unmeshed, tmp_path,
                                                     shape):
    tmp_u, res_u = unmeshed
    res = run(tmp_path, "m", shape)
    np.testing.assert_allclose(res.losses, res_u.losses, rtol=1e-5)
    want, _ = restored(tmp_u, "u")
    got, meta = restored(tmp_path, "m")
    assert meta["step"] == KW["steps"]
    sharp = _sharp_masks(KW["steps"])
    n_params = len(sharp)
    for g, w, m in zip(got[:n_params], want[:n_params], sharp):
        d = np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64))
        assert d[m.numpy()].max(initial=0) <= 1e-2 * LR
        assert d.max(initial=0) <= 2 * LR


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_each_device_holds_its_blocks(tmp_path, monkeypatch, shape):
    """The state the sharded step receives: every block is its spec's
    shape (the moments' ZeRO-1 specs), every device holds exactly
    ``sharded_bytes`` of parameters and of moments."""
    seen = []
    real = trainer.make_sharded_train_step

    def spy(cfg, api, opt, mesh):
        step = real(cfg, api, opt, mesh)

        def watched(params, opt_state, batch):
            seen.append((mesh, params, opt_state))
            return step(params, opt_state, batch)
        return watched

    monkeypatch.setattr(trainer, "make_sharded_train_step", spy)
    run(tmp_path, "m", shape, steps=2)
    assert len(seen) == 2
    for mesh, params, opt_state in seen:
        whole_p = shardings.gather_tree(params)
        whole_o = shardings.gather_tree(opt_state)
        for tree, whole, zero1 in ((params, whole_p, False),
                                   (opt_state, whole_o, True)):
            specs = shardings.tree_specs(whole, mesh, zero1)
            for leaf, spec in zip(shardings.tree_leaves(tree),
                                  shardings._spec_leaves(specs, whole)):
                assert leaf.spec == spec
                for idx in np.ndindex(mesh.devices.shape):
                    sl = leaf.slices(idx)
                    assert tuple(leaf.blocks[idx].shape) == tuple(
                        s.stop - s.start for s in sl)
                    assert leaf.blocks[idx].device == mesh.devices[idx]
            assert (shardings.device_bytes(tree) == shardings.sharded_bytes(
                whole, specs, mesh)).all()
    if shape[1] == 2:      # the model axis really splits some leaf
        p = seen[0][1]["layers"]["attn"]["wq"]
        assert p.spec[-1] == "model"
        assert p.blocks[0, 0].shape[-1] * 2 == p.shape[-1]


def test_resume_on_a_2x2_mesh_is_bit_exact(tmp_path):
    run(tmp_path, "ref", (2, 2))
    with pytest.raises(SimulatedFailure):
        run(tmp_path, "int", (2, 2), fail_at_step=3)
    res = run(tmp_path, "int", (2, 2))
    assert res.steps_run == 2 and res.final_step == KW["steps"]
    assert same_files(tmp_path, "ref", "int")


def test_meshed_and_unmeshed_runs_resume_from_each_other(unmeshed,
                                                         tmp_path):
    """An unmeshed run killed at step 3 and resumed on a (1, 2) mesh from
    its step-2 checkpoint, and the other way round, end on the
    uninterrupted unmeshed run's files."""
    tmp_u, _ = unmeshed
    for first, then, name in ((None, (1, 2), "a"), ((1, 2), None, "b")):
        with pytest.raises(SimulatedFailure):
            run(tmp_path, name, first, fail_at_step=3)
        res = run(tmp_path, name, then)
        assert res.steps_run == 2          # from the step-2 checkpoint
        (da, ma), (db, mb) = front(tmp_u, "u"), front(tmp_path, name)
        for n in ma["leaves"]:
            assert filecmp.cmp(da / n, db / n, shallow=False), (name, n)


def test_one_by_one_mesh_matches_jax_train(tmp_path):
    """The JAX package's ``train`` from its own init, and the port's on a
    (1, 1) mesh from that init carried across (a step-0 checkpoint the
    trainer resumes from): the same losses (rtol 1e-5) and final
    parameters (atol 1e-2 lr where the gradient is above f32 noise, 2 lr
    elsewhere)."""
    steps, batch, seq = 2, 2, 16
    jcfg = jax_config("qwen3-0.6b").scaled_down(num_layers=1, d_model=32,
                                                vocab_size=128, d_ff=64)
    jres = jtrain.train(jcfg, steps=steps, batch=batch, seq=seq,
                        ckpt_dir=str(tmp_path / "jax"), ckpt_interval=2,
                        lr=LR, seed=0, log_every=0)
    # the JAX trajectory again, for the gradients' noise masks
    japi_ = japi.get_model(jcfg)
    jparams = japi_.init_params(jcfg, jax.random.key(0))
    jopt = jadamw(lr=jcosine(LR, warmup=max(steps // 20, 1), total=steps))
    jgrad = jax.jit(jtrain.make_grad_fn(jcfg, japi_))
    jstep = jax.jit(jtrain.make_train_step(jcfg, japi_, jopt))
    jstate = jopt.init(jparams)
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    SlotStore(tmp_path / "port" / "state").save(
        [params, adamw().init(params)], meta={"step": 0})
    sharp = [np.ones(np.shape(a), bool) for a in jax.tree.leaves(jparams)]
    for b in token_batches(cfg.vocab_size, batch, seq, steps, seed=0):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        _, grads = jgrad(jparams, jb)
        for m, g in zip(sharp, jax.tree.leaves(grads)):
            g = np.abs(np.asarray(g))
            m &= (g == 0) | (g >= 1e-4 * g.max(initial=0))
        jparams, jstate, _ = jstep(jparams, jstate, jb)
    res = trainer.train(cfg, steps=steps, batch=batch, seq=seq,
                        ckpt_dir=str(tmp_path / "port"), ckpt_interval=2,
                        lr=LR, seed=0, log_every=0,
                        mesh=make_host_mesh((1, 1), device="cpu"))
    assert res.steps_run == steps
    np.testing.assert_allclose(res.losses, jres.losses, rtol=1e-5)
    got, _ = SlotStore(tmp_path / "port" / "state").restore()
    want, _ = SlotStore(tmp_path / "jax" / "state").restore()
    assert len(got) == len(want)
    for g, w, m in zip(got, want, sharp):
        d = np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64))
        assert d[m].max(initial=0) <= 1e-2 * LR
        assert d.max(initial=0) <= 2 * LR


def test_data_shard_devices_follow_the_batch_spec():
    mesh = make_host_mesh((2, 2), device="cpu")
    assert len(trainer.data_shard_devices(mesh, 4)) == 2
    assert len(trainer.data_shard_devices(mesh, 3)) == 1    # replicated
    shardings.set_strategy("dp")
    try:
        assert len(trainer.data_shard_devices(mesh, 4)) == 4
    finally:
        shardings.set_strategy("tp")


@pytest.mark.parametrize("mesh", [make_production_mesh(),
                                  make_fleet_mesh(2, device="cpu")])
def test_a_mesh_without_lm_devices_is_refused(tmp_path, mesh):
    with pytest.raises(ValueError, match="LMMesh"):
        trainer.train(CFG, steps=1, batch=2, seq=8, ckpt_dir=str(tmp_path),
                      mesh=mesh, device="cpu")


def test_sharded_update_is_the_unmeshed_update_bitwise():
    """``update_sharded`` on a (2, 2) mesh, where the parameter and ZeRO-1
    moment blocks of a leaf cover different slices, against one unmeshed
    AdamW update from the same gradient: every block bitwise, on its
    device, under its spec."""
    mesh = make_host_mesh((2, 2), device="cpu")
    cfg = dataclasses.replace(CFG, num_layers=2)
    params = get_model(cfg).init_params(cfg, seed=3, device="cpu")
    g = torch.Generator().manual_seed(0)
    grads = shardings.tree_map(
        lambda p: torch.randn(p.shape, generator=g).to(p.dtype), params)
    opt = adamw(lr=LR)
    state = opt.init(params)
    state = state._replace(m=shardings.tree_map(
        lambda m: torch.randn(m.shape, generator=g), state.m),
        v=shardings.tree_map(lambda v: torch.rand(v.shape, generator=g),
                             state.v))
    want_p, want_s = opt.update(grads, state, params)
    sp = shardings.shard_tree(params, shardings.tree_specs(params, mesh),
                              mesh)
    ss = shardings.shard_tree(state, shardings.tree_specs(state, mesh,
                                                          zero1=True), mesh)
    differ = sum(pl.spec != ml.spec for pl, ml in zip(
        shardings.tree_leaves(sp), shardings.tree_leaves(ss.m)))
    assert differ > 0
    got_p, got_s = trainer.update_sharded(opt, grads, ss, sp)
    for got, was, want in ((got_p, sp, want_p), (got_s, ss, want_s)):
        for a, w, b in zip(shardings.tree_leaves(got),
                           shardings.tree_leaves(was),
                           shardings.tree_leaves(want)):
            assert a.spec == w.spec
            for idx in np.ndindex(mesh.devices.shape):
                assert a.blocks[idx].device == mesh.devices[idx]
                assert torch.equal(a.blocks[idx], b[a.slices(idx)])

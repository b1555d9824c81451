"""SONIC's idempotence mechanisms in the port (``repro_torch.core``:
``LoopOrderedBuffer``, ``SparseUndoLog``, ``ResumableLoop``,
``run_intermittent``; ``core.tasks``) against the JAX package's, on the
CPU.

The sweeps of ``tests/test_idempotence.py`` run at small sizes through
both packages: a power failure is injected after every energy prefix
the budget allows, and resumed execution must converge to the
uninterrupted result.  Both packages are numpy on the same inputs, so
every comparison is exact: the results, and each device's ``DeviceStats``
(live cycles, reboots, cycles and invocations by op class).
"""

import dataclasses

import numpy as np
import pytest

import repro.core as jcore
import repro.core.energy as jenergy
import repro.core.tasks as jtasks
import repro_torch.core as tcore
import repro_torch.core.energy as tenergy
import repro_torch.core.tasks as ttasks

#: (core package, its energy module, its tasks module), one per package.
PACKAGES = {"jax": (jcore, jenergy, jtasks),
            "torch": (tcore, tenergy, ttasks)}


def _device(energy, cycles):
    return energy.Device(energy.PowerSystem("test", cycles, recharge_s=0.0))


def _run_to_completion(pkg, fn, nv, budget, max_reboots=100_000):
    """Re-invoke ``fn`` across power failures with a fixed budget."""
    core, energy, _ = pkg
    device = _device(energy, budget)
    nv.device = device
    while True:
        try:
            fn(device)
            return device
        except core.PowerFailure:
            device.reboot()
            assert device.stats.reboots < max_reboots


def _stats(dev) -> dict:
    return dataclasses.asdict(dev.stats)


def _accumulate(pkg, budget):
    core, _, _ = pkg
    rng = np.random.default_rng(42)
    x = rng.normal(size=5).astype(np.float32)
    weights = rng.normal(size=4).astype(np.float32)
    nv = core.NVStore()

    def fn(device):
        buf = core.LoopOrderedBuffer(nv, "acc", (5,))
        for e in core.ResumableLoop(nv, "stage", len(weights)):
            buf.write_back(buf.read_front() + weights[e] * x)
            buf.swap()

    dev = _run_to_completion(pkg, fn, nv, budget)
    nv.device = None
    return core.LoopOrderedBuffer(nv, "acc", (5,)).front_raw(), dev


@pytest.mark.parametrize("budget", [59, 61, 67, 83, 131])
def test_loop_ordered_buffering_matches_jax(budget):
    got, tdev = _accumulate(PACKAGES["torch"], budget)
    want, jdev = _accumulate(PACKAGES["jax"], budget)
    np.testing.assert_array_equal(got, want)
    assert _stats(tdev) == _stats(jdev)
    assert tdev.stats.reboots > 0


def _undo_updates(pkg, budget):
    core, _, _ = pkg
    rng = np.random.default_rng(7)
    updates = [(int(rng.integers(4)), float(rng.normal()))
               for _ in range(10)]
    nv = core.NVStore()
    nv.alloc("y", (4,))

    def fn(device):
        log = core.SparseUndoLog(nv, "y")
        log.recover()
        while log.completed < len(updates):
            idx, delta = updates[log.completed]
            log.accumulate(idx, delta)

    dev = _run_to_completion(pkg, fn, nv, budget)
    return nv.raw("y").copy(), dev


@pytest.mark.parametrize("budget", list(range(37, 120, 16)))
def test_sparse_undo_log_matches_jax(budget):
    got, tdev = _undo_updates(PACKAGES["torch"], budget)
    want, jdev = _undo_updates(PACKAGES["jax"], budget)
    np.testing.assert_array_equal(got, want)
    assert _stats(tdev) == _stats(jdev)


def test_sparse_undo_log_never_double_applies_in_either_package():
    """Fail after every cycle count of one update: the value is always
    one apply, and the two packages take the same path each time."""
    for fail_after in range(1, 60):
        seen = {}
        for name, (core, energy, _) in PACKAGES.items():
            nv = core.NVStore()
            nv.alloc("y", (3,))
            nv.raw("y")[1] = 10.0
            dev = _device(energy, fail_after)
            nv.device = dev
            interrupted = False
            try:
                core.SparseUndoLog(nv, "y").accumulate(1, 5.0)
            except core.PowerFailure:
                interrupted = True
                dev.reboot()
                nv.device = _device(energy, 1e9)
                log = core.SparseUndoLog(nv, "y")
                log.recover()
                if log.completed == 0:
                    log.accumulate(1, 5.0)
            assert nv.raw("y")[1] == 15.0, (name, fail_after)
            seen[name] = (interrupted, _stats(dev))
        assert seen["torch"] == seen["jax"], fail_after


def _resumable(pkg, budget):
    core, _, _ = pkg
    n = 12
    nv = core.NVStore()
    nv.alloc("trace", (n,), np.int64, init=np.full(n, -1))

    def fn(device):
        for i in core.ResumableLoop(nv, "lp", n):
            nv.write("trace", i, i)

    dev = _run_to_completion(pkg, fn, nv, budget)
    return nv.raw("trace").copy(), dev


@pytest.mark.parametrize("budget", [19, 33, 47])
def test_resumable_loop_matches_jax(budget):
    got, tdev = _resumable(PACKAGES["torch"], budget)
    want, jdev = _resumable(PACKAGES["jax"], budget)
    np.testing.assert_array_equal(got, np.arange(12))
    np.testing.assert_array_equal(got, want)
    assert _stats(tdev) == _stats(jdev)


def _run_intermittent(pkg, budget):
    core, energy, _ = pkg
    nv = core.NVStore()
    nv.alloc("acc", (3,))
    dev = _device(energy, budget)
    nv.device = dev

    def fn():
        for i in core.ResumableLoop(nv, "k", 8):
            nv.write("acc", float(i), i % 3)

    stats = core.run_intermittent(dev, fn)
    return nv.raw("acc").copy(), stats


def test_run_intermittent_matches_jax():
    got, tstats = _run_intermittent(PACKAGES["torch"], 29)
    want, jstats = _run_intermittent(PACKAGES["jax"], 29)
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert tstats.reboots > 0


def _task_chain(pkg, budget, k):
    core, energy, tasks = pkg
    nv = core.NVStore()
    nv.alloc("out", (6,))
    dev = _device(energy, budget)
    nv.device = dev

    def body(log, i):
        log.write("out", float(i * i), i)

    tasks.TaskRunner(nv, dev).run(tasks.tile_loop(6, k, body))
    return nv.raw("out").copy(), dev


@pytest.mark.parametrize("k", [1, 2, 3])
def test_task_runner_matches_jax(k):
    """Alpaca-style tasks with a redo log: a failed task restarts from
    its beginning and the chain resumes at the failed task."""
    got, tdev = _task_chain(PACKAGES["torch"], 1400, k)
    want, jdev = _task_chain(PACKAGES["jax"], 1400, k)
    np.testing.assert_array_equal(got, np.arange(6.0) ** 2)
    np.testing.assert_array_equal(got, want)
    assert _stats(tdev) == _stats(jdev)
    assert tdev.stats.reboots > 0


def test_redo_log_reads_its_writes():
    for core, energy, tasks in PACKAGES.values():
        nv = core.NVStore()
        nv.alloc("a", (2,))
        log = tasks.RedoLog(nv, _device(energy, 1e9))
        log.write("a", 7.0, 1)
        assert log.read("a", 1) == 7.0
        assert nv.raw("a")[1] == 0.0
        log.commit()
        assert nv.raw("a")[1] == 7.0

"""The port's plan half against the JAX package's: ``build_plan`` /
``with_uplink`` and the paper's network weights must be equal array for
array (exact: plan extraction is the same numpy code), and the numpy
carriers of ``repro_torch.convert`` must round-trip."""

import dataclasses

import numpy as np
import pytest

from conftest import NET_SEEDS, make_random_net

from repro.core import fleetsim as jfs
from repro.core.intermittent import STRATEGIES
from repro_torch.convert import (numpy_layers, plan_fields, plan_from_numpy,
                                 simnet_from_numpy)
from repro_torch.core import fleetsim as tfs
from repro_torch.core.energy import custom_power_system as t_custom
from repro.core.energy import custom_power_system as j_custom


def _port_net(seed):
    net, x = make_random_net(seed)
    return net, simnet_from_numpy(numpy_layers(net), net.input_shape,
                                  net.name), x


def _assert_same(a, b):
    """Equal field for field, arrays bitwise with the same dtype."""
    fa, fb = plan_fields(a), plan_fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        va, vb = fa[k], fb[k]
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert isinstance(va, np.ndarray) and isinstance(vb, np.ndarray)
            assert va.dtype == vb.dtype, k
            np.testing.assert_array_equal(va, vb, err_msg=k)
        else:
            assert va == vb, k


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("seed", NET_SEEDS)
def test_build_plan_matches_jax(seed, strategy):
    jnet, tnet, x = _port_net(seed)
    for power in ("1mF", "100uF"):
        _assert_same(jfs.build_plan(jnet, x, strategy, power),
                     tfs.build_plan(tnet, x, strategy, power))


@pytest.mark.parametrize("seed", NET_SEEDS)
def test_parametric_tails_and_uplink_match_jax(seed):
    jnet, tnet, x = _port_net(seed)
    jp = jfs.build_plan(jnet, x, "tails", "1mF", parametric=True)
    tp = tfs.build_plan(tnet, x, "tails", "1mF", parametric=True)
    _assert_same(jp, tp)
    _assert_same(jfs.with_uplink(jp), tfs.with_uplink(tp))
    assert tfs.with_uplink(tfs.with_uplink(tp)).kind.shape == \
        tfs.with_uplink(tp).kind.shape


def test_burn_rows_match_jax():
    """A capacitor small enough that TAILS calibration burns charges
    (BURN rows) gives the same plan in both packages."""
    jnet, tnet, x = _port_net(3)
    jp = jfs.build_plan(jnet, x, "tails", j_custom(3000))
    tp = tfs.build_plan(tnet, x, "tails", t_custom(3000))
    assert (tp.kind == tfs.KIND_BURN).any()
    _assert_same(jp, tp)


def test_bucket_and_bound_helpers_match_jax():
    jnet, tnet, x = _port_net(1)
    plans_j = [jfs.build_plan(jnet, x, s, "1mF") for s in ("sonic", "tails")]
    plans_t = [plan_from_numpy(plan_fields(p)) for p in plans_j]
    sj, st = jfs._pad_stack(plans_j), tfs._pad_stack(plans_t)
    for k in sj:
        np.testing.assert_array_equal(sj[k], st[k])
    caps = np.array([1e6, 2e4])
    for lane_axis, rows_j, rows_t in ((True, sj, st),
                                      (False, jfs._plan_rows(plans_j[0]),
                                       tfs._plan_rows(plans_t[0]))):
        bj = jfs._bucket_rows(rows_j, lane_axis)
        bt = tfs._bucket_rows(rows_t, lane_axis)
        for k in bj:
            np.testing.assert_array_equal(bj[k], bt[k])
        c = caps if lane_axis else caps[:1]
        np.testing.assert_array_equal(
            jfs._reboot_upper_bound(bj, c, lane_axis),
            tfs._reboot_upper_bound(bt, c, lane_axis))
    assert tfs._bucket_target(100) == jfs._bucket_target(100) == 128


@pytest.mark.parametrize("name", ("mnist", "har", "okg"))
def test_paper_network_weights_match_jax(name):
    from repro.models.dnn import NETWORKS as J
    from repro_torch.models.dnn import NETWORKS as T

    jl, tl = numpy_layers(J[name]()), numpy_layers(T[name]())
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k]
    assert J[name]().input_shape == T[name]().input_shape


@pytest.mark.parametrize("seed", NET_SEEDS)
def test_convert_round_trips(seed):
    jnet, tnet, x = _port_net(seed)
    assert [type(l).__name__ for l in tnet.layers] == \
        [type(l).__name__ for l in jnet.layers]
    again = simnet_from_numpy(numpy_layers(tnet), tnet.input_shape,
                              tnet.name)
    for a, b in zip(numpy_layers(tnet), numpy_layers(again)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(tnet.ref_forward(x), jnet.ref_forward(x))
    plan = tfs.build_plan(tnet, x, "sonic", "1mF")
    back = plan_from_numpy(plan_fields(plan))
    _assert_same(plan, back)
    # the arrays are copies, not views of the source plan
    back.n[...] = -1.0
    assert not np.array_equal(back.n, plan.n)
    with pytest.raises(ValueError):
        plan_from_numpy(dict(plan_fields(plan), bogus=1))
    with pytest.raises(ValueError):
        simnet_from_numpy([{"type": "Bogus"}], (1, 4, 4))


def test_restamped_plan_carries_over():
    """A JAX plan restamped to another capacitor (the differential
    harness's idiom) crosses over unchanged."""
    jnet, _tnet, x = _port_net(2)
    jp = dataclasses.replace(jfs.build_plan(jnet, x, "tile-8", "1mF"),
                             capacity=1234.0, recharge_s=0.5)
    _assert_same(jp, plan_from_numpy(plan_fields(jp)))

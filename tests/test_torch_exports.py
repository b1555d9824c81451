"""The port's packages export every name of their JAX twins: ``__all__``
of ``repro_torch.core``, ``.runtime``, ``.checkpoint``, ``.optim`` and
``.serving`` equals that of ``repro.core``, ``.runtime``, ``.checkpoint``,
``.optim`` and ``.serving``, and every exported name resolves."""

import importlib

import pytest


@pytest.mark.parametrize("pkg", ["core", "runtime", "checkpoint", "optim",
                                 "serving"])
def test_all_equals_the_jax_twin(pkg):
    port = importlib.import_module(f"repro_torch.{pkg}")
    ref = importlib.import_module(f"repro.{pkg}")
    assert port.__all__ == ref.__all__
    for name in port.__all__:
        assert hasattr(port, name), name


def test_mesh_exports_the_fleet_half():
    from repro_torch.launch import mesh

    for name in ("make_fleet_mesh", "fleet_all_reduce", "mesh_chips",
                 "FleetMesh"):
        assert hasattr(mesh, name), name

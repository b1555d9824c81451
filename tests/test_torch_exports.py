"""The port's packages export every name of their JAX twins: ``__all__``
of ``repro_torch.core``, ``.runtime``, ``.checkpoint``, ``.optim`` and
``.serving`` equals that of ``repro.core``, ``.runtime``, ``.checkpoint``,
``.optim`` and ``.serving``, and every exported name resolves; the
modules ``repro_torch.launch.train`` and ``repro_torch.models.moe``, which
have no ``__all__``, define every public function and class that their
twins define."""

import importlib
import inspect

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


@pytest.mark.parametrize("module", ["launch.train", "models.moe"])
def test_module_defines_every_public_name_of_the_jax_twin(module):
    ref = importlib.import_module(f"repro.{module}")
    port = importlib.import_module(f"repro_torch.{module}")
    public = [name for name, obj in vars(ref).items()
              if not name.startswith("_")
              and (inspect.isfunction(obj) or inspect.isclass(obj))
              and obj.__module__ == ref.__name__]
    assert public
    for name in public:
        obj = getattr(port, name, None)
        assert obj is not None, name
        assert getattr(obj, "__module__", None) == port.__name__, name

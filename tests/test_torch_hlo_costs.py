"""The port's structural HLO cost parser (``repro_torch.launch.hlo_costs``,
a copy of the JAX package's) on the HLO texts of
``tests/test_hlo_costs.py``: the JAX package compiles them in a subprocess
with 8 forced host devices (so the pytest process keeps its one device)
and prints each text with its own ``analyze(...).as_dict()``; the port's
``analyze`` must give the same dict on each text, and the four
hand-computed figures must hold.
"""

import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import hlo_costs

SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys, json
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch import hlo_costs
from repro.launch.mesh import compat_make_mesh

out = {}
mesh = compat_make_mesh((2, 4), ("data", "model"))

def keep(name, compiled):
    text = compiled.as_text()
    out[name] = {"text": text, "jax": hlo_costs.analyze(text).as_dict()}

# 1) nested scan: 3 x 5 = 15 matmuls of 64^3
W = jnp.zeros((64, 64), jnp.float32)
def inner(c, _): return c @ W, None
def outer(c, _):
    y, _ = lax.scan(inner, c, None, length=5)
    return y, None
def f(x):
    y, _ = lax.scan(outer, x, None, length=3)
    return y
keep("nested", jax.jit(f).lower(
    jax.ShapeDtypeStruct((64, 64), jnp.float32)).compile())

# 2) sharded row-parallel matmul: exact per-device flops + all-reduce bytes
def g(x, w):
    return x @ w
xs = jax.ShapeDtypeStruct((64, 128), jnp.float32)
ws = jax.ShapeDtypeStruct((128, 128), jnp.float32)
keep("sharded", jax.jit(g, in_shardings=(
    NamedSharding(mesh, P("data", "model")),
    NamedSharding(mesh, P("model", None)))).lower(xs, ws).compile())

# 3) collective inside a scan body is multiplied by the trip count
def h(x, w):
    def step(c, _):
        return jnp.tanh(c @ w), None
    y, _ = lax.scan(step, x, None, length=7)
    return y
keep("scan", jax.jit(h, in_shardings=(
    NamedSharding(mesh, P("data", "model")),
    NamedSharding(mesh, P("model", None)))).lower(xs, ws).compile())
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def texts():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, src],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["nested", "sharded", "scan"])
def test_analyze_equals_jax_s(texts, name):
    got = hlo_costs.analyze(texts[name]["text"]).as_dict()
    assert got == texts[name]["jax"]


def test_nested_scan_trip_counts(texts):
    r = hlo_costs.analyze(texts["nested"]["text"])
    assert r.flops == 15 * 2 * 64**3
    assert r.unresolved_while == 0


def test_sharded_per_device_flops(texts):
    # lhs (32,32) x rhs (32,128) per device = 2*32*32*128
    assert hlo_costs.analyze(texts["sharded"]["text"]).flops == \
        2 * 32 * 32 * 128


def test_allreduce_bytes_exact(texts):
    # partial-sum output (32,128) f32 = 16384 bytes
    r = hlo_costs.analyze(texts["sharded"]["text"])
    assert r.collectives.get("all-reduce", 0.0) == 32 * 128 * 4


def test_collective_inside_scan_multiplied(texts):
    r = hlo_costs.analyze(texts["scan"]["text"])
    assert r.collectives.get("all-reduce", 0.0) == 7 * 32 * 128 * 4


def test_imports_only_the_standard_library():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(hlo_costs))
    names = {a.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names}
    names |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert names <= {"__future__", "math", "re", "collections",
                     "dataclasses"}

"""Logical-to-physical sharding rules, and the placement of an LM's state on
an :class:`~repro_torch.launch.mesh.LMMesh`: the counterpart of the JAX
package's ``repro.launch.shardings``.

Parameters are matched by leaf name (the last path component) against a
rules table mapping the *trailing* dimensions to mesh axes; leading stacked
dimensions (layers, super-blocks) are replicated.  DP = batch over
(pod, data); TP = feature/head/vocab over model; EP = expert over model;
SP = sequence over data for the B=1 long-context cells.

A spec here is a tuple with one entry per dimension: a mesh axis name,
a tuple of axis names, or None -- the entries of the JAX package's
``PartitionSpec``, normalized as it normalizes them (a one-axis tuple
becomes the bare name).  ``()`` replicates a leaf of any rank, as ``P()``
does; compare specs of one leaf with both padded with None to its rank
(:func:`pad_spec`), since ``P() != P(None, None)``.

One process drives every shard; no ``torch.distributed`` process group is
involved.  :func:`shard_tree` gives each device of the mesh its block of
every leaf (the counterpart of placing a tree by ``NamedSharding``) and
:func:`gather_tree` gives each leaf back whole by exact concatenation (the
counterpart of ``jax.device_get``).  :func:`sharded_bytes` is the exact
per-device byte count of a tree under its specs, which the sharded trainer
holds its placement to and the dry run reports.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..models.config import ModelConfig, ShapeCell
from ..optim.adamw import _leaves as tree_leaves, _map as tree_map
from .mesh import dp_axes

M = "model"

#: Global sharding strategy (set by the launcher):
#:   "tp"  -- baseline: TP over model for features/heads/experts, DP over
#:            data(+pod), SP residuals, FSDP lead dims (Megatron-style
#:            mapping).
#:   "dp"  -- pure data parallelism over BOTH axes: weights replicated,
#:            batch sharded 256-way.  Right for small models where TP=16
#:            is all collective and no compute.
#:   "ep"  -- GShard MoE mapping: batch shards over BOTH axes (full 256-way
#:            DP for attention/norm compute), experts own the model axis
#:            (dispatch/combine all-to-alls move tokens, never expert
#:            weights), every non-expert weight is FSDP-sharded on a
#:            divisible dim over data and gathered per layer.
_STRATEGY = "tp"

#: leaves that keep their model-axis sharding under the "ep" strategy
EP_KEEP_MODEL = {"we_gate", "we_up", "we_down"}

#: "ep" storage shards for the embedding tables (gathered at use)
EP_OVERRIDES = {"embed": ("data", None), "lm_head": (None, "data")}


def set_strategy(name: str) -> None:
    global _STRATEGY
    if name not in ("tp", "dp", "ep"):
        raise ValueError(f"unknown strategy {name!r}; expected 'tp', 'dp' "
                         f"or 'ep'")
    _STRATEGY = name


def get_strategy() -> str:
    return _STRATEGY


#: leaf name -> spec of TRAILING dims (rightmost-aligned).
PARAM_RULES: dict[str, tuple] = {
    # embeddings / head
    "embed": (None, M),
    "lm_head": (None, M),
    # attention (column-parallel QKV, row-parallel O)
    "wq": (None, M), "wk": (None, M), "wv": (None, M), "wo": (M, None),
    "bq": (M,), "bk": (M,), "bv": (M,),
    "q_norm": (None,), "k_norm": (None,),
    # dense MLP
    "w_gate": (None, M), "w_up": (None, M), "w_down": (M, None),
    # MoE (expert parallel; router replicated)
    "router": (None, None),
    "we_gate": (M, None, None), "we_up": (M, None, None),
    "we_down": (M, None, None),
    "ws_gate": (None, M), "ws_up": (None, M), "ws_down": (M, None),
    # mamba2
    "in_proj": (None, M), "out_proj": (M, None),
    "conv_w": (None, M), "conv_b": (M,),
    "A_log": (M,), "Dskip": (M,), "dt_bias": (M,), "gnorm": (M,),
    # norms
    "ln": (None,), "ln1": (None,), "ln2": (None,), "ln3": (None,),
    "final_norm": (None,), "enc_norm": (None,), "scale": (None,),
}


#: params/opt leaves at or above this many elements get their stacked layer
#: dim sharded over "data" (FSDP/ZeRO-3 style).  109B-param llama4 would
#: otherwise need 13.6 GB of parameters per chip under TP-only sharding.
FSDP_MIN_ELEMS = 1 << 24


def param_spec(name: str, shape, mesh=None, zero1: bool = False) -> tuple:
    """Spec for one param; axes that do not divide the dim are dropped
    (a placement needs exact divisibility).  ``zero1`` additionally spreads
    optimizer-state leaves over the data axis (ZeRO-1)."""
    if _STRATEGY == "dp":
        # weights replicated; only ZeRO-1 spreads the optimizer moments
        if zero1 and mesh is not None:
            sizes = dict(mesh.shape)
            for i, s in enumerate(shape):
                if s % sizes.get("data", 1) == 0 and s >= sizes.get("data", 1):
                    return tuple([None] * i + ["data"]
                                 + [None] * (len(shape) - i - 1))
        return ()
    rule = PARAM_RULES.get(name)
    if rule is None:
        return ()
    if _STRATEGY == "ep" and name not in EP_KEEP_MODEL:
        rule = EP_OVERRIDES.get(
            name, tuple(None if ax == M else ax for ax in rule))
    ndim = len(shape)
    lead = ndim - len(rule)
    if lead < 0:           # smaller than rule (e.g. unstacked single layer)
        rule = rule[-ndim:] if ndim else ()
        lead = 0
    full = list((None,) * lead + tuple(rule))
    if mesh is not None:
        sizes = dict(mesh.shape)
        full = [ax if ax is None or shape[i] % sizes.get(ax, 1) == 0 else
                None for i, ax in enumerate(full)]
        elems = math.prod(shape)
        # FSDP: large stacked tensors also shard their layer dim over data.
        if (lead >= 1 and elems >= FSDP_MIN_ELEMS and full[0] is None
                and shape[0] % sizes.get("data", 1) == 0):
            full[0] = "data"
        # ZeRO-1: optimizer moments spread over data on any divisible dim.
        if zero1 and "data" not in full:
            for i, ax in enumerate(full):
                if ax is None and shape[i] % sizes.get("data", 1) == 0 \
                        and shape[i] >= sizes.get("data", 1):
                    full[i] = "data"
                    break
    return tuple(full)


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_specs(tree, mesh=None, zero1: bool = False):
    """Specs matching a params / optimizer-state tree: dicts by key, a
    named tuple (``optim.OptState``) by field name, lists and tuples
    inheriting their parent's name; a leaf is anything with a ``shape``."""
    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if _is_namedtuple(node):
            return type(node)(*(walk(v, f)
                                for v, f in zip(node, node._fields)))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        shape = tuple(getattr(node, "shape", ()))
        return param_spec(name, shape, mesh, zero1)
    return walk(tree, "")


def pad_spec(spec, ndim: int) -> tuple:
    """``spec`` padded with None to ``ndim`` entries."""
    return tuple(spec) + (None,) * (ndim - len(spec))


# --------------------------------------------------------------------------
# Inputs / caches per shape cell
# --------------------------------------------------------------------------

def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def spec_entry(axes: tuple):
    """A spec entry for a tuple of axes, as ``PartitionSpec`` normalizes
    it: None for none, the bare name for one."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def batch_spec(mesh, global_batch: int) -> tuple:
    """Shard batch over (pod, data) if divisible, else data, else replicate.
    Under the "dp" and "ep" strategies the model axis joins the
    data-parallel pool."""
    dp = dp_axes(mesh)
    if _STRATEGY in ("dp", "ep"):
        # widest DP grid that divides the batch; on the multi-pod mesh a
        # batch smaller than the chip count prefers (data, model) and lets
        # the pod axis replicate rather than leaving the model axis to
        # replicate compute
        candidates = [tuple(list(dp) + ["model"])]
        if "pod" in dp:
            candidates.append(("data", "model"))
        candidates.append(tuple(dp))
        for axes in candidates:
            full = math.prod(mesh.shape[a] for a in axes)
            if global_batch % full == 0:
                return axes
    sizes = {a: mesh.shape[a] for a in dp}
    full = math.prod(sizes.values())
    if _div(global_batch, full):
        return dp
    if _div(global_batch, sizes.get("data", 1)):
        return ("data",)
    return ()


def input_specs(cfg: ModelConfig, cell: ShapeCell, mesh,
                spec_shapes: dict) -> dict:
    """Specs of a cell's inputs (``models.input_spec_shapes``)."""
    b = spec_entry(batch_spec(mesh, cell.global_batch))
    out = {}
    for name in spec_shapes:
        if name in ("tokens", "labels"):
            out[name] = (b, None)
        elif name in ("frames", "patches"):
            out[name] = (b, None, None)
        elif name == "token":
            out[name] = (b,)
        else:
            out[name] = ()
    return out


def cache_specs(cfg: ModelConfig, cell: ShapeCell, mesh,
                cache_shapes: dict) -> dict:
    """Decode-state specs (``models.cache_spec_shapes``).  Batch over DP
    when divisible; for the B=1 long-context cells, the sequence dim of KV
    caches shards over data (SP) and SSM state heads shard over model."""
    b = spec_entry(batch_spec(mesh, cell.global_batch))
    data_n = mesh.shape.get("data", 1)
    model_n = mesh.shape.get("model", 1)
    out = {}
    for name, (shape, _) in cache_shapes.items():
        if name in ("k", "v", "xk", "xv"):
            L, B, KV, S, hd = shape
            # KV heads rarely divide the model axis (GQA); the sequence dim
            # always does at these lengths, so the cache shards
            # (batch->data, seq->model) -- the flash-decoding layout.
            kv_ax = M if _div(KV, model_n) else None
            seq_ax = M if kv_ax is None and _div(S, model_n) else None
            if b is not None:
                out[name] = (None, b, kv_ax, seq_ax, None)
            else:
                d_ax = "data" if _div(S, data_n) else None
                out[name] = (None, None, kv_ax, d_ax, None)
        elif name == "ssm":
            L, B, H, N, Pd = shape
            h_ax = M if _div(H, model_n) else None
            out[name] = (None, b, h_ax, None, None)
        elif name == "conv":
            L, B, K, C = shape
            c_ax = M if _div(C, model_n) else None
            out[name] = (None, b, None, c_ax)
        else:
            out[name] = ()
    return out


def logical_summary(cfg: ModelConfig, mesh) -> str:
    """Human-readable sharding summary."""
    dp = "x".join(str(mesh.shape[a]) for a in dp_axes(mesh))
    return (f"DP={dp} TP={mesh.shape.get('model', 1)}"
            f"{' EP over model' if cfg.is_moe else ''}")


# --------------------------------------------------------------------------
# Placement
# --------------------------------------------------------------------------

def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def sharded_bytes(tree, specs, mesh) -> int:
    """Exact per-device bytes of ``tree`` (leaves with ``shape`` and a
    torch ``dtype``: tensors, meta tensors, :class:`Sharded` leaves) under
    ``specs`` on ``mesh``: each leaf's bytes over the product of the axis
    sizes its spec names, summed -- the JAX dry run's arithmetic."""
    total = 0
    for leaf, spec in zip(tree_leaves(tree), _spec_leaves(specs, tree)):
        n = math.prod(leaf.shape)
        denom = math.prod(mesh.shape[a] for e in spec for a in _axes(e))
        total += n * _itemsize(leaf.dtype) // max(denom, 1)
    return total


def _spec_leaves(specs, like) -> list:
    """The specs of ``specs`` in the order of ``like``'s leaves (a spec is a
    tuple, so it is told from a sequence of specs by the tree it
    matches)."""
    if isinstance(like, dict):
        return [s for k in sorted(like)
                for s in _spec_leaves(specs[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [s for sp, lk in zip(specs, like)
                for s in _spec_leaves(sp, lk)]
    return [specs]


@dataclass(eq=False)
class Sharded:
    """One leaf placed on a mesh: ``blocks`` is a numpy object array in the
    mesh's shape holding each device's block, a tensor on that device;
    devices along an axis ``spec`` does not name hold equal copies."""
    spec: tuple
    shape: tuple
    dtype: torch.dtype
    blocks: np.ndarray
    mesh: object

    @property
    def nbytes_per_device(self) -> np.ndarray:
        return np.vectorize(lambda b: b.numel() * b.element_size(),
                            otypes=[np.int64])(self.blocks)

    def slices(self, idx) -> tuple:
        """The slices of the leaf that the device at mesh index ``idx``
        holds."""
        return _block_slices(self.shape, self.spec, self.mesh, idx)


def _block_slices(shape, spec, mesh, idx) -> tuple:
    """The slices of a leaf that the device at mesh index ``idx`` holds."""
    where = dict(zip(mesh.axis_names, idx))
    out = []
    for i, e in enumerate(pad_spec(spec, len(shape))):
        axes = _axes(e)
        if not axes:
            out.append(slice(0, shape[i]))
            continue
        parts = math.prod(mesh.shape[a] for a in axes)
        if shape[i] % parts:
            raise ValueError(f"dim {i} of a {tuple(shape)} leaf does not "
                             f"split over {axes} ({parts} shards)")
        j = 0
        for a in axes:             # row-major over the entry's axes
            j = j * mesh.shape[a] + where[a]
        step = shape[i] // parts
        out.append(slice(j * step, (j + 1) * step))
    return tuple(out)


def shard(x: torch.Tensor, spec, mesh) -> Sharded:
    """``x`` placed on ``mesh`` by ``spec``: each device's block copied to
    it, except that the first device holding the whole of ``x`` on ``x``'s
    own device keeps ``x`` itself (so a one-device mesh copies nothing)."""
    if mesh.devices is None:
        raise ValueError("an abstract mesh holds no blocks")
    spec = tuple(spec)
    blocks = np.empty(mesh.devices.shape, dtype=object)
    whole = tuple(slice(0, n) for n in x.shape)
    kept = False
    for idx in np.ndindex(mesh.devices.shape):
        dev = mesh.devices[idx]
        sl = _block_slices(x.shape, spec, mesh, idx)
        if sl == whole and not kept and x.device == dev:
            blocks[idx], kept = x, True
        else:
            blocks[idx] = x[sl].to(dev, copy=True).contiguous()
    return Sharded(spec, tuple(x.shape), x.dtype, blocks, mesh)


def shard_tree(tree, specs, mesh):
    """Every leaf of ``tree`` placed on ``mesh`` by its spec in ``specs``
    (:func:`shard`): the tree with :class:`Sharded` leaves."""
    return tree_map(lambda x, s: shard(x, s, mesh), tree, specs)


def gather(leaf, device=None) -> torch.Tensor:
    """The whole tensor of a :class:`Sharded` leaf on ``device`` (default:
    the first device's), each distinct block copied into its place; a leaf
    that one block covers is that block itself where it already lies on
    ``device``.  A plain tensor comes back as it is (moved to
    ``device``)."""
    if not isinstance(leaf, Sharded):
        return leaf if device is None else leaf.to(device)
    first = leaf.blocks.flat[0]
    device = first.device if device is None else torch.device(device)
    if tuple(first.shape) == leaf.shape:
        return first if first.device == device else first.to(device)
    out = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
    seen = set()
    for idx in np.ndindex(leaf.blocks.shape):
        sl = leaf.slices(idx)
        key = tuple((s.start, s.stop) for s in sl)
        if key not in seen:
            seen.add(key)
            out[sl] = leaf.blocks[idx].to(device)
    return out


def gather_tree(tree, device=None):
    """Every :class:`Sharded` leaf of ``tree`` whole (:func:`gather`)."""
    return tree_map(lambda x: gather(x, device), tree)


def device_bytes(tree) -> np.ndarray:
    """The bytes each device of the mesh holds of ``tree``'s
    :class:`Sharded` leaves, in the mesh's shape."""
    leaves = [x for x in tree_leaves(tree) if isinstance(x, Sharded)]
    return sum((x.nbytes_per_device for x in leaves),
               np.zeros(leaves[0].blocks.shape, dtype=np.int64))

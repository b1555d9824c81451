"""Durable checkpoint store with the paper's consistency mechanisms at
datacenter scale.

* **Loop-ordered buffering** -> A/B slot directories + an atomically-renamed
  MANIFEST pointer: a crash mid-write can only tear the *back* slot; the
  front slot named by the committed manifest is always complete.
* **Loop continuation** -> a tiny cursor file (step / microbatch / data
  position) committed atomically after every unit of progress, so a restart
  resumes at the interrupted unit instead of the last full checkpoint.
* **Sparse undo-logging** -> delta checkpoints (sparse_delta.py) guard
  in-place mutations of large state with read/write cursor files.

The PyTorch counterpart of the JAX package's ``checkpoint/store.py``:
leaf files are byte for byte the ones that package writes for the same
arrays; only the manifest's ``treedef`` string is the port's own, and its
``dtypes`` field (each leaf's dtype) is the port's addition.  A leaf of a
dtype numpy has no type for (bf16, the float8 types) is written as its
raw bits, an unsigned integer array of the same width, and restored bit
for bit as a tensor of the dtype the manifest names (the JAX package
writes such an array as untyped ``|V2`` bytes).
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

import numpy as np
import torch

#: Float dtypes that numpy has no type for, by name, and the unsigned
#: integer type of the same width their raw bits are saved as.
_RAW_BITS = {name: np.uint16 if name == "bfloat16" else np.uint8
             for name in ("bfloat16", "float8_e4m3fn", "float8_e4m3fnuz",
                          "float8_e5m2", "float8_e5m2fnuz", "float8_e8m0fnu")
             if hasattr(torch, name)}
_SIGNED = {np.uint16: torch.int16, np.uint8: torch.uint8}


def atomic_write_bytes(path: Path, data: bytes) -> None:
    """Single-file analogue of an atomic NV word write."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def atomic_write_json(path: Path, obj) -> None:
    atomic_write_bytes(path, json.dumps(obj, indent=1).encode())


class SlotStore:
    """A/B double-buffered checkpoint slots with an atomic front pointer."""

    MANIFEST = "MANIFEST.json"

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        for slot in ("A", "B"):
            (self.root / slot).mkdir(exist_ok=True)

    # -- front/back discipline ----------------------------------------------
    def manifest(self) -> dict | None:
        p = self.root / self.MANIFEST
        if not p.exists():
            return None
        try:
            return json.loads(p.read_text())
        except json.JSONDecodeError:
            return None      # torn manifest write is impossible via rename,
                             # but tolerate external corruption

    def front_slot(self) -> str | None:
        m = self.manifest()
        return None if m is None else m["slot"]

    def back_slot(self) -> str:
        return "B" if self.front_slot() == "A" else "A"

    # -- tree save/restore -----------------------------------------------------
    def save(self, tree, meta: dict | None = None) -> str:
        """Write every leaf into the back slot, then commit by manifest
        rename (the pointer swap).  Interrupting anywhere before the final
        rename leaves the committed front untouched.  ``tree`` is a nested
        dict / list / tuple of tensors or numpy arrays; leaves are written
        in the JAX package's order (dict keys sorted, sequences in order),
        each as the ``.npy`` file that package writes (a bf16 or float8
        leaf as its raw bits, the dtype kept in the manifest's
        ``dtypes``)."""
        slot = self.back_slot()
        slot_dir = self.root / slot
        leaves = _flatten(tree)
        names, dtypes = [], []
        for i, leaf in enumerate(leaves):
            name = f"leaf{i:05d}.npy"
            arr, dtype = _host_array(leaf)
            with open(slot_dir / (name + ".tmp"), "wb") as f:
                np.save(f, arr)
            os.replace(slot_dir / (name + ".tmp"), slot_dir / name)
            names.append(name)
            dtypes.append(dtype)
        manifest = {
            "slot": slot,
            "leaves": names,
            "treedef": _treedef_repr(tree),
            "meta": meta or {},
            "dtypes": dtypes,
        }
        atomic_write_json(self.root / self.MANIFEST, manifest)
        return slot

    def restore(self, like=None):
        """Load the committed front slot.  ``like`` (a tree of the saved
        structure) supplies the structure; where its leaf is a tensor the
        restored leaf is a tensor of that leaf's dtype on its device, else
        the array as saved: numpy, or a CPU tensor for a leaf saved as raw
        bits (bf16, float8), which numpy cannot hold.  Restore is
        mesh-agnostic: callers place leaves wherever the current run needs
        them (elastic rescale)."""
        m = self.manifest()
        if m is None:
            return None, None
        slot_dir = self.root / m["slot"]
        dtypes = m.get("dtypes") or [None] * len(m["leaves"])
        arrays = [_from_host(np.load(slot_dir / n), dt)
                  for n, dt in zip(m["leaves"], dtypes)]
        if like is not None:
            tree = _unflatten(like, iter(arrays))
        else:
            tree = arrays
        return tree, m["meta"]


def _flatten(tree) -> list:
    """The leaves of ``tree`` in the JAX package's order: dict keys sorted,
    lists and tuples in order; ``None`` is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _flatten(t)]
    return [tree]


def _unflatten(like, leaves):
    """``like``'s structure filled from the iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        items = [_unflatten(t, leaves) for t in like]
        # a named tuple (an optimizer state) takes its fields one by one
        return type(like)(*items) if hasattr(like, "_fields") \
            else type(like)(items)
    arr = next(leaves)
    if isinstance(like, torch.Tensor):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
        return t.to(device=like.device, dtype=like.dtype)
    return arr


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """The numpy array written for ``leaf`` and the leaf's dtype name: a
    dtype of :data:`_RAW_BITS` as its raw bits."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        name = str(leaf.dtype).removeprefix("torch.")
        if name in _RAW_BITS:
            bits = _RAW_BITS[name]
            return (leaf.contiguous().view(_SIGNED[bits]).numpy()
                    .view(bits), name)
        return leaf.numpy(), name
    arr = np.asarray(leaf)
    name = arr.dtype.name
    if name in _RAW_BITS:                 # an ml_dtypes array
        return np.ascontiguousarray(arr).view(_RAW_BITS[name]), name
    return arr, name


def _from_host(arr: np.ndarray, dtype: str | None):
    """A loaded leaf: a CPU tensor of ``dtype`` for raw bits, else the
    numpy array."""
    if dtype not in _RAW_BITS:
        return arr
    bits = _RAW_BITS[dtype]
    return torch.from_numpy(np.ascontiguousarray(arr).view(bits).view(
        np.int16 if bits is np.uint16 else np.uint8)).view(
            getattr(torch, dtype))


def _treedef_repr(tree) -> str:
    """A readable description of ``tree``'s structure (``*`` a leaf)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef_repr(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_treedef_repr(t) for t in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


class Cursor:
    """Loop-continuation cursor: tiny, atomically-committed progress record.

    Commit cost is O(bytes of the cursor) -- the fleet analogue of SONIC
    writing a loop index to FRAM instead of checkpointing the world."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def read(self) -> dict:
        if not self.path.exists():
            return {}
        try:
            return json.loads(self.path.read_text())
        except json.JSONDecodeError:
            return {}

    def commit(self, **fields) -> None:
        cur = self.read()
        cur.update(fields)
        atomic_write_json(self.path, cur)

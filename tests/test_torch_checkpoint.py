"""The port's checkpoint store (``repro_torch.checkpoint``: A/B slots,
cursors, sparse deltas) against the JAX package's, on the CPU.

The cases of ``tests/test_checkpoint.py``, and the leaf files: saving the
same numpy tree with both packages' ``SlotStore`` must write byte-equal
``leafNNNNN.npy`` files (the manifest's ``treedef`` string is each
package's own), whether the port is handed numpy arrays or tensors.  The
port's bf16 and float8 leaves (which the JAX package writes as untyped
bytes) round-trip bit for bit with their dtypes.
"""

import json

import numpy as np
import pytest
import torch

from repro.checkpoint import SlotStore as JaxSlotStore
from repro_torch.checkpoint import Cursor, SlotStore, SparseDeltaFile
from repro_torch.optim import adamw


def _tree():
    rng = np.random.default_rng(0)
    return {"b": {"c": np.arange(4, dtype=np.int32),
                  "a": rng.normal(size=(3,)).astype(np.float64)},
            "a": rng.normal(size=(2, 3)).astype(np.float32),
            "layers": [np.ones(2, np.float32),
                       {"w": np.full((2, 2), 7, np.int64)}]}


def _as_tensors(tree):
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_tensors(v) for v in tree]
    return torch.from_numpy(tree.copy())


@pytest.mark.parametrize("leaves", ["numpy", "tensors"])
def test_leaf_files_byte_equal_to_jax(tmp_path, leaves):
    tree = _tree()
    JaxSlotStore(tmp_path / "jax").save(tree, meta={"step": 3})
    mine = tree if leaves == "numpy" else _as_tensors(tree)
    SlotStore(tmp_path / "port").save(mine, meta={"step": 3})
    mj = json.loads((tmp_path / "jax" / "MANIFEST.json").read_text())
    mp = json.loads((tmp_path / "port" / "MANIFEST.json").read_text())
    assert mp["leaves"] == mj["leaves"] and len(mj["leaves"]) == 5
    assert (mp["slot"], mp["meta"]) == (mj["slot"], mj["meta"])
    for name in mj["leaves"]:
        want = (tmp_path / "jax" / mj["slot"] / name).read_bytes()
        got = (tmp_path / "port" / mp["slot"] / name).read_bytes()
        assert got == want, name


def test_slot_store_roundtrip(tmp_path):
    store = SlotStore(tmp_path / "ck")
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.ones(4, np.int32)}}
    store.save(tree, meta={"step": 7})
    got, meta = store.restore(like=tree)
    assert meta["step"] == 7
    np.testing.assert_array_equal(got["a"], tree["a"])
    np.testing.assert_array_equal(got["b"]["c"], tree["b"]["c"])
    flat, _ = store.restore()
    assert [a.shape for a in flat] == [(2, 3), (4,)]


def test_slot_store_restores_tensors_like_tensors(tmp_path):
    store = SlotStore(tmp_path / "ck")
    tree = [torch.arange(5, dtype=torch.float64), {"z": torch.ones(2)}]
    store.save(tree)
    got, _ = store.restore(like=tree)
    assert torch.is_tensor(got[0]) and torch.equal(got[0], tree[0])
    assert torch.equal(got[1]["z"], tree[1]["z"])


def test_slot_store_alternates_and_survives_torn_back_slot(tmp_path):
    store = SlotStore(tmp_path / "ck")
    t1 = {"w": np.full(8, 1.0, np.float32)}
    t2 = {"w": np.full(8, 2.0, np.float32)}
    s1 = store.save(t1, meta={"step": 1})
    s2 = store.save(t2, meta={"step": 2})
    assert s1 != s2, "slots must alternate (A/B buffering)"
    back = store.back_slot()
    (store.root / back / "leaf00000.npy").write_bytes(b"GARBAGE")
    got, meta = store.restore(like=t2)
    assert meta["step"] == 2
    np.testing.assert_array_equal(got["w"], t2["w"])


def test_cursor_atomic_commit(tmp_path):
    c = Cursor(tmp_path / "cur.json")
    assert c.read() == {}
    c.commit(step=3)
    c.commit(data_pos=11)
    assert c.read() == {"step": 3, "data_pos": 11}


def test_sparse_delta_update_and_recovery(tmp_path):
    f = SparseDeltaFile(tmp_path / "emb.npy", shape=(10, 4))
    f.update_rows(np.asarray([2, 5]), np.ones((2, 4), np.float32))
    assert f.completed == 1
    arr = f.read()
    np.testing.assert_array_equal(arr[2], np.ones(4))
    np.testing.assert_array_equal(arr[0], np.zeros(4))
    orig = arr.copy()
    rows = np.asarray([1])
    with open(f.undo_path, "wb") as fh:
        np.savez(fh, rows=rows, values=orig[rows])
    cur = json.loads(f.cursor_path.read_text())
    f._set_cursors(cur["read"] + 1, cur["write"])
    mm = np.load(f.path, mmap_mode="r+")
    mm[1] = 99.0
    mm.flush()
    f.recover()
    np.testing.assert_array_equal(f.read(), orig)
    f.update_rows(rows, np.full((1, 4), 7.0, np.float32))
    assert f.read()[1, 0] == 7.0


def test_sparse_delta_files_match_jax(tmp_path):
    """The same updates through both packages leave the same array file,
    undo log and cursors."""
    from repro.checkpoint import SparseDeltaFile as JaxSparseDeltaFile

    files = {}
    for name, cls in (("jax", JaxSparseDeltaFile),
                      ("port", SparseDeltaFile)):
        (tmp_path / name).mkdir()
        f = cls(tmp_path / name / "big.npy", shape=(64, 8))
        f.update_rows(np.asarray([7, 3]), np.ones((2, 8), np.float32))
        f.update_rows(np.asarray([3]), np.full((1, 8), 2.0, np.float32))
        files[name] = f
    j, p = files["jax"], files["port"]
    assert p.path.read_bytes() == j.path.read_bytes()
    assert p.cursor_path.read_text() == j.cursor_path.read_text()
    uj, up = np.load(j.undo_path), np.load(p.undo_path)
    assert up["values"].shape == (1, 8)
    np.testing.assert_array_equal(up["rows"], uj["rows"])
    np.testing.assert_array_equal(up["values"], uj["values"])


# --------------------------------------------------------------------------
# bf16 and float8 leaves, the dtype of every published config's weights
# --------------------------------------------------------------------------

def _every_pattern(dtype):
    """A tensor of ``dtype`` holding every bit pattern of its width (NaNs,
    infinities and negative zero among them)."""
    if dtype == torch.bfloat16:
        bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    else:
        bits = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    return bits.view(dtype), bits


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn,
                                   torch.float8_e5m2])
def test_slot_store_round_trips_raw_bits_leaves(tmp_path, dtype):
    leaf, bits = _every_pattern(dtype)
    tree = {"w": leaf.reshape(-1, 16), "b": [torch.ones(3), leaf[:5]],
            "n": np.arange(4, dtype=np.int32)}
    store = SlotStore(tmp_path / "ck")
    store.save(tree, meta={"step": 2})
    name = str(dtype).removeprefix("torch.")
    # leaves in the JAX package's order: keys sorted, lists in order
    assert store.manifest()["dtypes"] == ["float32", name, "int32", name]
    got, meta = store.restore(like=tree)
    assert meta == {"step": 2}
    assert got["w"].dtype == dtype and got["w"].shape == (bits.numel() // 16,
                                                          16)
    assert torch.equal(got["w"].reshape(-1).view(bits.dtype), bits)
    assert torch.equal(got["b"][1].view(bits.dtype), bits[:5])
    np.testing.assert_array_equal(got["n"], tree["n"])
    flat, _ = store.restore()                  # no like: a tensor of dtype
    assert flat[1].dtype == dtype and isinstance(flat[0], np.ndarray)
    assert torch.equal(flat[1].view(bits.dtype), bits[:5])


def test_slot_store_restores_like_s_dtype_and_device(tmp_path):
    store = SlotStore(tmp_path / "ck")
    store.save([torch.arange(6, dtype=torch.float32)])
    got, _ = store.restore(like=[torch.zeros(6, dtype=torch.bfloat16)])
    assert got[0].dtype == torch.bfloat16 and got[0].device.type == "cpu"
    assert torch.equal(got[0], torch.arange(6, dtype=torch.bfloat16))


def test_slot_store_restores_an_optimizer_state(tmp_path):
    """A named tuple (the AdamW state) restores as itself."""
    opt = adamw(lr=1e-3)
    params = {"a": torch.ones(3, dtype=torch.bfloat16), "b": torch.zeros(2)}
    state = opt.init(params)
    store = SlotStore(tmp_path / "ck")
    store.save([params, state])
    (gp, gs), _ = store.restore(like=[params, state])
    assert type(gs) is type(state) and gs.step.dtype == torch.int32
    assert gp["a"].dtype == torch.bfloat16 and torch.equal(gp["a"],
                                                           params["a"])
